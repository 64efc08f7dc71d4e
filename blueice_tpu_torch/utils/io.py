"""Atomic template-cache IO and data-file resolution.

Role parity with the reference's pickle cache and file search
(reference: blueice/utils.py:43-77). Differences, by design:

* Atomic writes are implemented with a same-directory temp file + ``os.replace``
  (POSIX-atomic) instead of the ``atomicwrites`` dependency. This is what protects
  concurrent precompute workers that race on the same content-addressed cache file.
* ``save_npz``/``load_npz`` store dense numpy template arrays — the natural payload
  for device-resident templates — while ``save_pickle``/``read_pickle``
  remain for arbitrary python payloads (task files).
* ``data_file_name`` *raises* FileNotFoundError when the file is absent. (The
  reference *returns* the exception instance — a known bug at blueice/utils.py:49 —
  which we deliberately do not reproduce.)
"""

import os
import pickle
import tempfile

import numpy as np

__all__ = ['data_file_name', 'find_file_in_folders', 'read_pickle', 'save_pickle',
           'load_npz', 'save_npz', 'atomic_write_bytes']


def data_file_name(filename, data_dirs=None):
    """Return filename if the file exists; otherwise search ``data_dirs`` for it."""
    if os.path.exists(filename):
        return filename
    if data_dirs is not None:
        return find_file_in_folders(filename, data_dirs)
    raise FileNotFoundError(filename)


def find_file_in_folders(filename, folders):
    """Search for filename in folders, return the full path or raise
    FileNotFoundError. Does not recurse into subdirectories.
    """
    if isinstance(folders, str):
        folders = [folders]
    for folder in folders:
        full_path = os.path.join(folder, filename)
        if os.path.exists(full_path):
            return full_path
    raise FileNotFoundError(filename)


def atomic_write_bytes(data, filename):
    """Write bytes to filename atomically (temp file in same dir + os.replace)."""
    dirname = os.path.dirname(os.path.abspath(filename))
    os.makedirs(dirname, exist_ok=True)
    fd, tmp_path = tempfile.mkstemp(dir=dirname, prefix='.tmp_', suffix='.part')
    try:
        with os.fdopen(fd, 'wb') as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_path, filename)
    except BaseException:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise


def read_pickle(filename):
    with open(filename, mode='rb') as infile:
        return pickle.load(infile)


def save_pickle(stuff, filename):
    """Save stuff in a pickle at filename, atomically."""
    atomic_write_bytes(pickle.dumps(stuff, protocol=pickle.HIGHEST_PROTOCOL), filename)


def save_npz(arrays, filename):
    """Atomically save a dict of numpy arrays (plus scalars) as an .npz payload."""
    import io as _io
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    for k, v in payload.items():
        if v.dtype == object:
            # np.savez would silently pickle it and load_npz
            # (allow_pickle=False) would then fail at READ time, possibly on
            # a different worker — surface the error to the writer instead
            raise TypeError(
                "save_npz: %r has object dtype (not a numeric array); "
                "use save_pickle for arbitrary payloads" % k)
    buf = _io.BytesIO()
    np.savez(buf, **payload)
    atomic_write_bytes(buf.getvalue(), filename)


def load_npz(filename):
    """Load a dict of numpy arrays saved by save_npz."""
    with np.load(filename, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}
