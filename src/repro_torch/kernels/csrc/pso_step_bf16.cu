// pso_step with bfloat16 storage: pso_step.cu's kernel instantiated for
// __nv_bfloat16 positions, velocities, pbest, r1, r2, gbest and shift, in a
// translation unit of its own so that nvcc builds both types in parallel.
//
// Replaces src/repro/kernels/pso_step.py::pso_step (pallas_call at :98) with
// KernelConfig(dtype="bfloat16").
#include <cuda_bf16.h>

#define POPT_STORAGE __nv_bfloat16
#define POPT_ENTRY pso_step_bf16_launch
#include "pso_step.cu"
