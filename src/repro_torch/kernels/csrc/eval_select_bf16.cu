// eval_select with bfloat16 storage: eval_select.cu's kernels instantiated
// for __nv_bfloat16 incumbents, trials, shift and new population, in a
// translation unit of their own so that nvcc builds both types in parallel.
//
// Replaces src/repro/kernels/eval_select.py::eval_select (pallas_call at
// :86) with KernelConfig(dtype="bfloat16").
#include <cuda_bf16.h>

#define POPT_STORAGE __nv_bfloat16
#define POPT_ENTRY eval_select_bf16_launch
#include "eval_select.cu"
