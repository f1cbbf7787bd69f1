from .fit import (FitParams, default_fit_optimizer, fit, l2_loss,
                  make_fit_step, make_fit_step_kernel)

__all__ = ["FitParams", "default_fit_optimizer", "fit", "l2_loss",
           "make_fit_step", "make_fit_step_kernel"]
