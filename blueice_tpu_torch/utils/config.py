"""Config-dict plumbing: merging, canonicalization and deterministic hashing.

The config dict is the backbone of the framework: it fully determines a source's PDF
template, and its hash is the content address of the on-disk template cache.

Role parity with the reference's ``combine_dicts`` / ``hashablize`` /
``deterministic_hash`` (reference: blueice/utils.py:27-101), but the hash here is a
canonical byte encoding rather than a pickle dump: pickle bytes depend on protocol
and interpreter details, while this encoding is stable across processes, hosts and
Python versions — a requirement for a template cache shared between hosts.
"""

from copy import deepcopy
from hashlib import sha1
import inspect
import types

import numpy as np

__all__ = ['combine_dicts', 'hashablize', 'deterministic_hash',
           'canonical_bytes', 'inherit_docstring_from']


def inherit_docstring_from(cls):
    """Decorator: copy the docstring of the same-named method of ``cls``."""
    def docstring_inheriting_decorator(fn):
        fn.__doc__ = getattr(cls, fn.__name__).__doc__
        return fn
    return docstring_inheriting_decorator


def combine_dicts(*args, exclude=(), deep_copy=False):
    """Return a new dict with entries from all dicts passed, later dicts overriding
    earlier ones.
    :param exclude: remove these keys from the result.
    :param deep_copy: deepcopy the dicts before combining them.
    """
    if not len(args):
        return dict()
    result = {}
    for d in args:
        if deep_copy:
            d = deepcopy(d)
        result.update(d)
    return {k: v for k, v in result.items() if k not in exclude}


def hashablize(obj):
    """Convert a container hierarchy into one that can be hashed (nested tuples)."""
    try:
        hash(obj)
    except TypeError:
        if isinstance(obj, dict):
            return tuple((k, hashablize(v)) for (k, v) in sorted(obj.items()))
        elif isinstance(obj, np.ndarray):
            # Recurse: a >= 2-d array's tolist() is a list of LISTS, which
            # would still be unhashable
            return hashablize(obj.tolist())
        elif hasattr(obj, '__iter__'):
            return tuple(hashablize(o) for o in obj)
        else:
            raise TypeError("Can't hashablize object of type %r" % type(obj))
    else:
        return obj


def _canonical_parts(obj, out):
    """Append a canonical byte representation of obj to the list ``out``.

    Every branch starts with a type tag so e.g. the string "1" and the int 1 never
    collide. Unknown leaf objects fall back to a qualified-name or repr encoding.
    """
    if obj is None:
        out.append(b'N')
    elif isinstance(obj, bool):
        out.append(b'B1' if obj else b'B0')
    elif isinstance(obj, (int, np.integer)):
        out.append(b'I' + str(int(obj)).encode())
    elif isinstance(obj, (float, np.floating)):
        # repr of a float is exact (shortest round-trip representation)
        out.append(b'F' + repr(float(obj)).encode())
    elif isinstance(obj, (complex, np.complexfloating)):
        out.append(b'C' + repr(complex(obj)).encode())
    elif isinstance(obj, str):
        out.append(b'S' + obj.encode('utf8'))
    elif isinstance(obj, bytes):
        out.append(b'Y' + obj)
    elif isinstance(obj, np.ndarray):
        # Hash values only (not dtype), like the reference's ndarray->tuple conversion
        out.append(b'A(')
        _canonical_parts(obj.tolist(), out)
        out.append(b')')
    elif isinstance(obj, dict):
        out.append(b'D(')
        for k in sorted(obj.keys(), key=lambda k: (str(type(k)), str(k))):
            _canonical_parts(k, out)
            out.append(b':')
            _canonical_parts(obj[k], out)
            out.append(b',')
        out.append(b')')
    elif isinstance(obj, (list, tuple)):
        out.append(b'T(')
        for v in obj:
            _canonical_parts(v, out)
            out.append(b',')
        out.append(b')')
    elif isinstance(obj, (set, frozenset)):
        out.append(b'Z(')
        for v in sorted(obj, key=repr):
            _canonical_parts(v, out)
            out.append(b',')
        out.append(b')')
    elif inspect.isclass(obj):
        out.append(b'K' + ('%s.%s' % (obj.__module__, obj.__qualname__)).encode())
    elif isinstance(obj, types.CodeType):
        # Nested code objects (a lambda inside a lambda appears in co_consts)
        out.append(b'Q<')
        out.append(obj.co_code)
        _canonical_parts(tuple(obj.co_names), out)
        _canonical_parts(tuple(obj.co_consts), out)
        out.append(b'>')
    elif callable(obj):
        qn = getattr(obj, '__qualname__', None)
        mod = getattr(obj, '__module__', '')
        if qn is not None and '<lambda>' not in qn and '<locals>' not in qn:
            out.append(b'L' + ('%s.%s' % (mod, qn)).encode())
        else:
            # Local functions / lambdas: code identity = bytecode + referenced
            # globals + consts + DEFAULTS + CAPTURED CLOSURE CELL VALUES.
            # Two lambdas differing only via a captured variable (e.g.
            # ``lambda x: x * scale`` with different ``scale``) must hash
            # differently, or the template cache silently aliases them.
            code = getattr(obj, '__code__', None)
            if code is not None:
                out.append(b'L<')
                out.append(code.co_code)
                _canonical_parts(tuple(code.co_names), out)
                _canonical_parts(tuple(code.co_consts), out)
                _canonical_parts(getattr(obj, '__defaults__', None), out)
                cells = getattr(obj, '__closure__', None) or ()
                out.append(b'c(')
                for cell in cells:
                    try:
                        _canonical_parts(cell.cell_contents, out)
                    except ValueError:   # empty cell
                        out.append(b'E')
                    out.append(b',')
                out.append(b')>')
            else:
                out.append(b'R' + repr(obj).encode())
    elif hasattr(obj, '__iter__'):
        out.append(b'T(')
        for v in obj:
            _canonical_parts(v, out)
            out.append(b',')
        out.append(b')')
    else:
        out.append(b'R' + repr(obj).encode())


def canonical_bytes(obj):
    """Return a canonical byte encoding of a (nested) container hierarchy."""
    out = []
    _canonical_parts(obj, out)
    return b''.join(out)


def deterministic_hash(thing):
    """Return a deterministic sha1 hex digest of a container hierarchy.

    Stable across processes and hosts (unlike pickle-based hashing), so cache files
    written by one worker are found by every other.
    """
    return sha1(canonical_bytes(thing)).hexdigest()
