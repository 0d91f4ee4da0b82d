// ga_step with bfloat16 storage: ga_step.cu's kernels instantiated for
// __nv_bfloat16 parents, slot rows, um, noise and shift, in a translation
// unit of their own so that nvcc builds both types in parallel.
//
// Replaces src/repro/kernels/ga_step.py::ga_step (pallas_call at :98) with
// KernelConfig(dtype="bfloat16").
#include <cuda_bf16.h>

#define POPT_STORAGE __nv_bfloat16
#define POPT_ENTRY ga_step_bf16_launch
#include "ga_step.cu"
