"""Checkpoints (port of ``repro/checkpoint``): the same on-disk format, so
either package restores the other's."""
from .store import AsyncCheckpointer, ChecksumError, latest_step, named_leaves, restore, save

__all__ = ["AsyncCheckpointer", "ChecksumError", "latest_step", "named_leaves", "restore", "save"]
