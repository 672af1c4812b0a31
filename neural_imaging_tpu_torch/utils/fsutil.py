"""Filesystem helpers: copy of ``listdir`` of ``neural_imaging_tpu/utils/fsutil.py``."""
import os
import re


def listdir(dirname, pattern=None, dirs_only=False):
    """Sorted entries of a directory, optionally only directories and only
    names that a regex ``pattern`` matches (from their start)."""
    entries = sorted(os.listdir(dirname))
    if dirs_only:
        entries = [e for e in entries if os.path.isdir(os.path.join(dirname, e))]
    if pattern is not None:
        rx = re.compile(pattern)
        entries = [e for e in entries if rx.match(e)]
    return entries
