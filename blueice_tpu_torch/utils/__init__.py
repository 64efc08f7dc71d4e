from .config import (combine_dicts, hashablize, deterministic_hash,
                     canonical_bytes, inherit_docstring_from)
from .io import (data_file_name, find_file_in_folders, read_pickle, save_pickle,
                 load_npz, save_npz, atomic_write_bytes)
from .grids import (arrays_to_grid, events_to_analysis_dimensions,
                    InterpolateAndExtrapolate1D)
from .data_reading import read_csv, read_files_in, FILE_READERS
from .progress import (progress_iter, set_progress, trace, profile_to, count,
                       set_tracing, take)

# Backwards-compatible alias used by the reference API
_events_to_analysis_dimensions = events_to_analysis_dimensions
