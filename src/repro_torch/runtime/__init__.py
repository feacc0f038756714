"""Fault tolerance for training: the checkpoint/restart supervisor and the
straggler monitor."""
