// de_step with bfloat16 storage: de_step.cu's kernels instantiated for
// __nv_bfloat16 pop, u, shift and new population, in a translation unit of
// their own so that nvcc builds both types in parallel.
//
// Replaces src/repro/kernels/de_step.py::de_step (pallas_call at :85) with
// KernelConfig(dtype="bfloat16").
#include <cuda_bf16.h>

#define POPT_STORAGE __nv_bfloat16
#define POPT_ENTRY de_step_bf16_launch
#include "de_step.cu"
