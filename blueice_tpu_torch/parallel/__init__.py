from .fitter import make_toy_fitter, minimize_newton
from .toys import BinnedToyStudy, UnbinnedToyStudy, ToyResults
