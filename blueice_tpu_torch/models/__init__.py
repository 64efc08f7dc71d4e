from .source import (Source, HistogramPdfSource, DensityEstimatingSource,
                     MonteCarloSource)
from .model import Model
from .jax_source import JaxDensitySource, prefill_anchor_templates
