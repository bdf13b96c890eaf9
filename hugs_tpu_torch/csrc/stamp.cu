// The device clock at a point of a stream, for the spans of a captured
// training step (utils/profiling.py).
//
// One thread reads the GPU's global nanosecond timer (%globaltimer) and
// writes it to stamps[(row % n_rows) * n_marks + mark], row read from the
// device: a graph replayed many times writes each replay's stamps into
// the ring row its own counter names, so that the host can read them all
// at one drain. In stream order the stamp runs once the work before it
// has finished, as a CUDA event's record does.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* stamps, const long long* row,
                             int mark, int n_marks, int n_rows) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long r = *row % n_rows;
  stamps[r * n_marks + mark] = static_cast<long long>(t);
}

}  // namespace

// stamps (n_rows, n_marks) int64 and row () int64 on the device;
// 0 <= mark < n_marks. Launches on `stream`; returns the cudaError of
// the launch.
extern "C" int hugs_stamp(long long* stamps, const long long* row, int mark,
                          int n_marks, int n_rows, void* stream) {
  if (mark < 0 || mark >= n_marks || n_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      stamps, row, mark, n_marks, n_rows);
  return static_cast<int>(cudaGetLastError());
}
