// bench_eval with bfloat16 storage: bench_eval.cu's kernels instantiated for
// __nv_bfloat16 rows and shift, in a translation unit of their own so that
// nvcc builds both types in parallel.
//
// Replaces src/repro/kernels/bench_eval.py::bench_eval (pallas_call at :136)
// with KernelConfig(dtype="bfloat16").
#include <cuda_bf16.h>

#define POPT_STORAGE __nv_bfloat16
#define POPT_ENTRY bench_eval_bf16_launch
#include "bench_eval.cu"
