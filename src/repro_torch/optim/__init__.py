"""Local optimizers of popt4jlib in PyTorch: numeric gradients, the descent
methods and their batched polish layer, and Adam."""
from repro_torch.optim import adam  # noqa: F401
from repro_torch.optim.adam import AdamConfig, AdamState  # noqa: F401
from repro_torch.optim.descent import (  # noqa: F401
    DescentConfig, PolishConfig, asd, avd, bfgs, fcg, make_polish,
    polish_evals_per_point)
from repro_torch.optim.numgrad import make_grad, richardson_grad  # noqa: F401
