"""Train a reduced LM for a few hundred steps on the port, with the full
stack: prefetching data pipeline, AdamW + cosine, async checkpointing,
failure recovery, straggler monitor. On the card by default; add
``--device cpu`` to run the plain PyTorch path on the CPU.

    PYTHONPATH=src python examples/train_lm_torch.py --arch smollm-360m \\
        --steps 200 --device cpu
"""
import os
import sys
import tempfile

from repro_torch.launch import train

if __name__ == "__main__":
    sys.argv = [sys.argv[0], "--reduced", "--steps", "200", "--batch", "8",
                "--seq", "128", "--ckpt-every", "50",
                "--inject-failure-at", "120", "--ckpt-dir",
                tempfile.mkdtemp(prefix="train_lm_torch_")] + sys.argv[1:]
    train.main()
