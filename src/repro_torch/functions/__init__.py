from repro_torch.functions.benchmarks import (  # noqa: F401
    FUNCTIONS,
    Function,
    get,
    make_shifted_rosenbrock,
    shift_vector,
)
