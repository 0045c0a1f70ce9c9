// All the substeps of a tile-engine frame in one launch: for each substep,
// project over every row, a grid-wide barrier, apply over every row, and a
// barrier before the next substep reads the new state.
//
// Replaces starframe_tpu/pallas/tiles.py `_mega_kernel` (via `_run_mega`),
// which runs the same substeps x (project, apply) as the sequential grid
// of one pallas_call with the state double-buffered in VMEM. Here the
// phases are separated by `cooperative_groups::this_grid().sync()` in one
// cooperative launch (2 x substeps - 1 barriers), and the per-row bodies
// are the row loops of tile_rows.cuh (`project_row`, `apply_row`), whose
// float operations are those of K8/K9's (row, slot) items, so a frame is
// bitwise equal to the per-substep pair of tile_substep.cu. The state ping-pongs between two
// global buffers: apply reads its partners' pre-apply state from the
// 3-tile window while other blocks write theirs, so it writes the other
// buffer. A skipped tile (tile_live = 0) still zeroes its corrections and
// copies its state into the other buffer; `touched` is max-accumulated by
// its own row only. Integer barriers, no atomics on floats: reruns are
// bitwise equal.
//
// With CCD (the kCcd instance, tiles.py `_mega_kernel` with `ccd`: three
// phases a substep) each substep starts with K7's row body (`ccd_row`)
// writing every row's TOI factor into the `ccd.f` scratch (1 on a skipped
// tile and a row that is not a bullet, as `_run_mega`'s ones), then a
// barrier, then the project and apply phases' kCcd forms read it: bitwise
// equal to K7, K8 and K9 launched once a substep.
//
// What bounds it on an H100: bytes, as K8/K9. Each substep reads the solve
// tables (7.2 MB at the 10k pile) and the state and correction windows; the
// frame's working set (~10 MB) sits in the 50 MB L2. The design is the
// simple one: one thread per row, 64 rows a block as K8/K9, as many blocks
// as fit on the card at once (the occupancy query times the SM count, at
// most one per 64 rows), each looping over row groups. Shared-memory
// residency of the tables, TMA and block-size tuning are later work.

#include <cooperative_groups.h>

#include "tile_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;  // rows (threads) per block
constexpr int kGroups = kT / kRows;  // row groups per tile

// buffer b's field k: 0 the frame's input, 1 st_a, 2 st_b
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

template <bool kCcd>
__global__ void __launch_bounds__(kRows) tile_frame_kernel(TileFrameArgs f) {
  cg::grid_group grid = cg::this_grid();
  const int units = f.project.Nt * kGroups;
  for (int s = 0; s < f.substeps; ++s) {
    const int src = s == 0 ? 0 : ((s & 1) ? 2 : 1);  // see state_in
    const int odd = s & 1;
    TileProjectArgs p = f.project;
    p.px = state_in(f, src, 0); p.py = state_in(f, src, 1);
    p.an = state_in(f, src, 2); p.vx = state_in(f, src, 3);
    p.vy = state_in(f, src, 4); p.om = state_in(f, src, 5);
    if constexpr (kCcd) {
      TileCcdArgs c = f.ccd;
      c.px = p.px; c.py = p.py; c.an = p.an;
      c.vx = p.vx; c.vy = p.vy; c.om = p.om;
      for (int u = blockIdx.x; u < units; u += gridDim.x)
        ccd_row(c, u / kGroups, (u % kGroups) * kRows + threadIdx.x);
      grid.sync();
    }
    for (int u = blockIdx.x; u < units; u += gridDim.x)
      project_row<kCcd>(p, u / kGroups, (u % kGroups) * kRows + threadIdx.x);
    grid.sync();
    TileApplyArgs a = f.apply;
    a.px = p.px; a.py = p.py; a.an = p.an;
    a.vx = p.vx; a.vy = p.vy; a.om = p.om;
    a.o_px = state_out(f, odd, 0); a.o_py = state_out(f, odd, 1);
    a.o_an = state_out(f, odd, 2); a.o_vx = state_out(f, odd, 3);
    a.o_vy = state_out(f, odd, 4); a.o_om = state_out(f, odd, 5);
    for (int u = blockIdx.x; u < units; u += gridDim.x)
      apply_row<false, kCcd>(a, u / kGroups,
                             (u % kGroups) * kRows + threadIdx.x);
    if (s + 1 < f.substeps) grid.sync();
  }
}

}  // namespace

SF_EXPORT(sf_tile_frame, TileFrameArgs)

// The most blocks of tile_frame_kernel<kCcd> resident on device `dev` at
// once (occupancy x SM count), or the error that refuses a cooperative
// launch there. Queried once per device and instance and kept: the values
// are fixed for the process, and the frame loop is host-bound.
static constexpr int kMaxDevices = 64;

template <bool kCcd>
static cudaError_t resident_blocks(int dev, int* blocks) {
  static int cached[kMaxDevices] = {0};  // 0: not queried yet
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, coop = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tile_frame_kernel<kCcd>, kRows, 0);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

// Launches the frame cooperatively, so that every block is resident and
// the grid barriers cannot deadlock; a refused launch returns its error
// (the caller raises: there is no per-substep fallback).
extern "C" int sf_tile_frame(const TileFrameArgs* a, void* stream) {
  const int units = a->project.Nt * kGroups;
  if (units == 0 || a->substeps <= 0) return (int)cudaGetLastError();
  const bool ccd = a->ccd.f != nullptr;
  int dev = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = ccd ? resident_blocks<true>(dev, &resident)
              : resident_blocks<false>(dev, &resident);
  if (err != cudaSuccess) return (int)err;
  const int blocks = resident < units ? resident : units;
  TileFrameArgs args = *a;
  void* params[] = {&args};
  const void* kernel = ccd ? (const void*)tile_frame_kernel<true>
                           : (const void*)tile_frame_kernel<false>;
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kRows),
                                    params, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
