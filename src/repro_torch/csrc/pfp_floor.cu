// An empty kernel: the floor that no launch on the card goes under.
//
// Replaces no TPU kernel. It does no work, so its time in a CUDA graph of
// back-to-back launches is what one launch costs the device by itself;
// chip_smoke.py and tools/ab_kernel_times.py print it beside the times of
// the elementwise kernels, whose small calls sit near it.
#include "pfp_common.cuh"

namespace {

__global__ void pfp_empty_kernel() {}

}  // namespace

// One block of one warp.
PFP_EXPORT int pfp_empty_launch(void* stream) {
  pfp_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return pfp::launch_status();
}
