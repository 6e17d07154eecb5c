// Device stage marks of the evaluator's trace (utils/trace.py).
//
// Replaces no TPU kernel.  Added because a CUDA graph replay carries no
// host annotation onto the device's timeline: one empty kernel per stage,
// each named for its stage, so that a profiler's device record says which
// stage starts there.  A mark launched while a CUDA graph is being
// captured becomes a node of that graph and shows in every replay.  Every
// device record belongs to the stage of the last mark before it on its
// stream.
//
// Bound: launch latency alone (one thread, no memory traffic), a few
// microseconds of device time each, about seven a frame (AOT's frames
// add rvos_mark_lstt before the transformer).  The kernels
// are extern "C" so that their records carry the bare names
// rvos_mark_<stage>; the order of the switch is utils/trace.py's STAGES.

#include <cuda_runtime.h>

extern "C" __global__ void rvos_mark_upload() {}
extern "C" __global__ void rvos_mark_bank() {}
extern "C" __global__ void rvos_mark_extract() {}
extern "C" __global__ void rvos_mark_match() {}
extern "C" __global__ void rvos_mark_kmeans() {}
extern "C" __global__ void rvos_mark_decode() {}
extern "C" __global__ void rvos_mark_post() {}
extern "C" __global__ void rvos_mark_lstt() {}

// Launch stage `stage`'s mark on `stream`; returns cudaGetLastError().
extern "C" int rvos_mark_launch(int stage, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (stage) {
    case 0: rvos_mark_upload<<<1, 1, 0, s>>>(); break;
    case 1: rvos_mark_bank<<<1, 1, 0, s>>>(); break;
    case 2: rvos_mark_extract<<<1, 1, 0, s>>>(); break;
    case 3: rvos_mark_match<<<1, 1, 0, s>>>(); break;
    case 4: rvos_mark_kmeans<<<1, 1, 0, s>>>(); break;
    case 5: rvos_mark_decode<<<1, 1, 0, s>>>(); break;
    case 6: rvos_mark_post<<<1, 1, 0, s>>>(); break;
    case 7: rvos_mark_lstt<<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
