from . import xenon_like
