// A timestamp on the device's own clock, for the spans of utils/spans.py.
//
// One thread reads %globaltimer (nanoseconds, the clock every SM shares),
// takes the next slot of a ring atomically and writes the time there:
//
//     slot = buf[0]++;   buf[1 + slot % capacity] = globaltimer
//
// buf is one int64 tensor: the cursor (stamps written since the ring was
// made) followed by the ring, so that one copy brings both to the host.
// Launched on the stream of the work it marks, a stamp runs after that
// stream's earlier work and before its later work; launched while a CUDA
// graph is captured, it becomes a node of the graph, and each replay
// writes its own stamps.

#include <cuda_runtime.h>

extern "C" __global__ void go2_span_stamp(unsigned long long* buf,
                                          unsigned long long capacity) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long slot = atomicAdd(buf, 1ULL);
  buf[1 + slot % capacity] = t;
}

extern "C" int span_stamp_launch(unsigned long long* buf,
                                 unsigned long long capacity, void* stream) {
  go2_span_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(buf,
                                                                  capacity);
  return static_cast<int>(cudaGetLastError());
}
