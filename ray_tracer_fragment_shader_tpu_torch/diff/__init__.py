from .fit import (FitParams, default_fit_optimizer, fit,
                  make_fit_step_kernel)

__all__ = ["FitParams", "default_fit_optimizer", "fit",
           "make_fit_step_kernel"]
