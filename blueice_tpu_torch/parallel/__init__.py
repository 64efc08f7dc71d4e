from .tasks import (compute_single, compute_many, compute_all,
                    create_models_ipyparallel)
from .fitter import make_toy_fitter, minimize_newton
from .toys import (make_mesh, shard_toys, BinnedToyStudy, UnbinnedToyStudy,
                   ToyResults, seed_of, child_seed)
from .neyman import NeymanConstruction
from .limits import (toy_unified_intervals, toy_upper_limits, toy_lower_limits,
                     toy_central_intervals, sensitivity_band,
                     observed_interval)
from .discovery import (discovery_ts, observed_discovery,
                        asimov_discovery, discovery_reach)
from .cls import cls_curve, cls_upper_limit, cls_expected_band
from .asymptotics import (asimov_sigma, asimov_expected_limits,
                          asimov_median_limit)
from .coverage import coverage_check, clopper_pearson
from .ranking import nuisance_ranking
from .gof import saturated_logl, gof_ts, gof_pvalue
from .distributed import (init_distributed, global_mesh,
                          profile_ts_distributed, run_distributed)
