from .analysis import (CostSample, RooflineTerms, extrapolate,
                       model_flops_for, roofline_terms)
