// What the two whole-frame kernels share (tile_frame.cu: K10;
// tile_compound_frame.cu: the compound rows' frame): the state's ping-pong
// buffers and the cooperative launch, sized by the occupancy query.
//
// Buffers. Substep s reads the frame's input (s = 0) or the buffer substep
// s - 1 wrote, and its apply phase writes the other one, since it reads its
// partners' pre-apply state from the 3-tile window while other blocks write
// theirs: st_b when s is even, st_a when odd.
#pragma once

#include "common.cuh"

namespace {

// the buffer substep s reads: 0 the frame's input, 1 st_a, 2 st_b
__device__ __forceinline__ int state_src(int s) {
  return s == 0 ? 0 : ((s & 1) ? 2 : 1);
}

// buffer b's field k (b as state_src gives it)
__device__ __forceinline__ const float* state_in(const TileFrameArgs& f,
                                                 int b, int k) {
  const float* in[6] = {f.apply.px, f.apply.py, f.apply.an,
                        f.apply.vx, f.apply.vy, f.apply.om};
  return b == 0 ? in[k] : (b == 1 ? f.st_a[k] : f.st_b[k]);
}

// the buffer substep s writes: st_b when s is even, st_a when odd
__device__ __forceinline__ float* state_out(const TileFrameArgs& f, int odd,
                                            int k) {
  return odd ? f.st_a[k] : f.st_b[k];
}

constexpr int kMaxDevices = 64;

// The most blocks of `kernel` (`threads` a block) resident on device `dev`
// at once (occupancy x SM count), or the error that refuses a cooperative
// launch there. Queried once per device and kept in `cache` (one int a
// device, 0 before the query): the values are fixed for the process, and
// the frame loop is host-bound.
inline cudaError_t resident_blocks(const void* kernel, int threads, int dev,
                                   int* cache, int* blocks) {
  if (dev < kMaxDevices && cache[dev] > 0) {
    *blocks = cache[dev];
    return cudaSuccess;
  }
  int sms = 0, coop = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  if (dev < kMaxDevices) cache[dev] = *blocks;
  return cudaSuccess;
}

// Resident blocks an SM of `kernel` at `threads` a block; -1 if the query
// fails.
inline int blocks_per_sm(const void* kernel, int threads) {
  int blocks = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, kernel, threads, 0) == cudaSuccess
             ? blocks
             : -1;
}

// Launches `kernel` cooperatively with as many blocks as are resident at
// once, at most `units` (each block loops over the units), so that every
// block is resident and the grid barriers cannot deadlock; a refused
// launch returns its error (the caller raises: there is no per-substep
// fallback).
template <class Args>
int launch_frame(const void* kernel, int threads, int* cache, int units,
                 const Args* a, cudaStream_t stream) {
  int dev = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = resident_blocks(kernel, threads, dev, cache, &resident);
  if (err != cudaSuccess) return (int)err;
  const int blocks = resident < units ? resident : units;
  Args args = *a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads),
                                    params, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
