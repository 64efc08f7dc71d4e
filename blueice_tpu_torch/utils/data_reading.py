"""File-valued config settings.

A config value that is a string ending in a known extension stands for the
*contents* of that file: ``{'s1_relative_ly_map': 'ly_map.pkl'}`` behaves as if
the loaded map had been written into the config directly. This keeps configs
small, hashable and shippable to workers, while big payloads (maps, spectra)
live on disk and are loaded once per process.

Capability parity with the reference's config file-reader (reference:
blueice/data_reading.py); the registry here additionally knows ``.npy``.
"""

from copy import deepcopy
import os

import numpy as np

from .io import data_file_name, read_pickle

__all__ = ['read_csv', 'read_npy', 'read_files_in', 'resolve_setting',
           'FILE_READERS', 'CACHE']


def read_csv(filename):
    """Read a two-column (x, y) csv into a (2, n) float array.

    Accepts files with or without a header row. (The reference's reader
    unconditionally dropped the first row — blueice/data_reading.py:15-18 —
    which silently lost the first data point of header-less files; a numeric
    first row is kept here.)"""
    import pandas as pd
    frame = pd.read_csv(filename, delimiter=',', names=['x', 'y'],
                        comment='#')
    vals = frame.values
    try:
        return vals.astype(float).T       # header-less: every row is data
    except (TypeError, ValueError):
        return vals[1:].astype(float).T   # header row: drop it


def read_npy(filename):
    return np.load(filename, allow_pickle=False)


#: extension -> loader. Users may register their own loaders here.
FILE_READERS = {'.pkl': read_pickle, '.csv': read_csv, '.npy': read_npy}

#: resolved path -> loaded contents, so each file is read once per process
CACHE = dict()


def resolve_setting(value, data_dirs=('.',)):
    """If ``value`` is a string naming a file of a registered type, return that
    file's (cached) contents; any other value passes through unchanged."""
    if not isinstance(value, str):
        return value
    loader = FILE_READERS.get(os.path.splitext(value)[1])
    if loader is None:
        return value
    path = data_file_name(value, data_dirs)
    if path not in CACHE:
        CACHE[path] = loader(path)
    return CACHE[path]


def read_files_in(d, data_dirs=tuple('.')):
    """A new dict with every file-valued setting of ``d`` replaced by the file's
    contents (see :func:`resolve_setting`); other entries are deep-copied.
    :param data_dirs: directories searched for the named files.
    """
    return {k: resolve_setting(v, data_dirs)
            for k, v in deepcopy(d).items()}
