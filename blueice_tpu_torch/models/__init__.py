from .source import (Source, HistogramPdfSource, DensityEstimatingSource,
                     MonteCarloSource)
from .model import Model
