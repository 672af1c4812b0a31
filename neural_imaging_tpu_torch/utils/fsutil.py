"""Filesystem helpers: copy of ``listdir``, ``split`` and ``strip_prefix`` of
``neural_imaging_tpu/utils/fsutil.py``."""
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


def split(path):
    """Split a path into all of its components."""
    parts = []
    while True:
        head, tail = os.path.split(path)
        if tail:
            parts.insert(0, tail)
        if head == path:
            if head:
                parts.insert(0, head)
            break
        path = head
    return parts


def strip_prefix(path, prefix):
    path = os.path.normpath(path)
    prefix = os.path.normpath(prefix)
    if path.startswith(prefix):
        return path[len(prefix):].lstrip(os.sep)
    return path
