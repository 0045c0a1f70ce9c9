// One substep of the tile engine as two launches: project (integrate,
// derived; XPBD contact projection per solve slot against the partners'
// integrated poses; own-row Jacobi sums) and apply (count-normalised,
// clipped corrections; velocity reconstruction; the restitution/friction
// velocity pass against each partner's post-apply state derived from the
// correction windows; damping).
//
// Replaces starframe_tpu/pallas/tiles.py `_project_kernel` +
// `_project_math` and `_apply_kernel` + `_apply_math` (the per-substep pair
// `run_tiled_frame` launches with fuse=False; the fused whole-frame
// kernels, tile_frame.cu's K10 and tile_compound_frame.cu, are bitwise
// equal to this pair by contract). The bodies (`project_group`,
// `apply_group`) live in tile_rows.cuh, which the compound frame includes
// too. A non-null `accv` runs the apply phase's compound form
// (`_apply_kernel(compound=True)`): the velocity pass's raw sums go out
// for the caller's owner reduction.
//
// With CCD (cfg.ccd) a third launch comes first: K7 (`sf_tile_ccd`,
// replacing tiles.py `_ccd_kernel` + `_ccd_math`) writes each row's TOI
// factor f, and a non-null `f` in the project and apply arguments runs
// their `kCcd` forms, which scale the pose advance by it. K7 reads what
// K8 reads of a row (its solve slots' masks, anchors and normal, the
// window state) and writes one float a row, in K8's (row, slot) layout
// (`ccd_group`): each slot's chain of partner loads and four sincos runs
// beside the row's others, where a thread a row walked them in series.
//
// What bounds it on an H100: bytes. Each launch reads the solve tables
// (22 floats x Cs slots a row, of which a slot with no solve mask reads 2:
// ~1-3 MB at the piles' states) plus the state windows and writes ~1 MB:
// ~1-2 us at 3.35 TB/s; the math is ~200 flops a solved slot. What held
// the row-a-thread design back was latency: a thread walked its row's Cs
// slots in series, each a dependent chain (candidate index, six partner
// loads, two sincos, two contact points), at 2-5 warps an SM. Design: one
// thread a (row, slot) item, 32 rows x 8 slots in a 256-thread block (a
// tile is 8 blocks; 632 blocks at the compound pile's 79 tiles), so the
// slots' chains run side by side. Each item that solves a slot computes
// its row's own terms itself (no item waits on another before the sum),
// parks its contribution in shared memory, and one thread a row adds them
// in slot order (tile_rows.cuh), so the outputs are those of one thread
// walking the row's slots in order. The tables are [Nt, field, Cs, T]
// planes: a warp is 32 consecutive rows of one slot, so its table loads
// coalesce.
// Partner state is read from the 3-tile window in global memory (the
// frame's working set, ~10 MB, sits in the 50 MB L2). No atomics: every
// output has one writer, so reruns are bitwise equal.

#include "tile_rows.cuh"

namespace {

template <bool kCcd>
__global__ void __launch_bounds__(kItemThreads, kItemBlocks) tile_project_kernel(
    TileProjectArgs a) {
  __shared__ GroupShared sh;
  project_group<kCcd>(a, blockIdx.y, blockIdx.x, sh);
}

template <bool kCompound, bool kCcd>
__global__ void __launch_bounds__(kItemThreads, kItemBlocks) tile_apply_kernel(
    TileApplyArgs a) {
  __shared__ GroupShared sh;
  apply_group<kCompound, kCcd>(a, blockIdx.y, blockIdx.x, sh);
}

__global__ void __launch_bounds__(kItemThreads, kItemBlocks) tile_ccd_kernel(
    TileCcdArgs a) {
  __shared__ GroupShared sh;
  ccd_group(a, blockIdx.y, blockIdx.x, sh);
}

template <bool kCompound>
void apply_launch(const TileApplyArgs& a, dim3 grid, cudaStream_t st) {
  if (a.f)
    tile_apply_kernel<kCompound, true><<<grid, kItemThreads, 0, st>>>(a);
  else
    tile_apply_kernel<kCompound, false><<<grid, kItemThreads, 0, st>>>(a);
}

}  // namespace

SF_EXPORT(sf_tile_project, TileProjectArgs)
SF_EXPORT(sf_tile_apply, TileApplyArgs)
SF_EXPORT(sf_tile_ccd, TileCcdArgs)

extern "C" int sf_tile_project(const TileProjectArgs* a, void* stream) {
  const dim3 grid(kRowGroups, a->Nt);
  const cudaStream_t st = (cudaStream_t)stream;
  if (a->Nt > 0) {
    if (a->f)
      tile_project_kernel<true><<<grid, kItemThreads, 0, st>>>(*a);
    else
      tile_project_kernel<false><<<grid, kItemThreads, 0, st>>>(*a);
  }
  return (int)cudaGetLastError();
}

extern "C" int sf_tile_apply(const TileApplyArgs* a, void* stream) {
  const dim3 grid(kRowGroups, a->Nt);
  const cudaStream_t st = (cudaStream_t)stream;
  if (a->Nt > 0) {
    if (a->accv)
      apply_launch<true>(*a, grid, st);
    else
      apply_launch<false>(*a, grid, st);
  }
  return (int)cudaGetLastError();
}

// Resident blocks an SM of the (row, slot) instances: K8 (`apply` 0) or
// K9 (`apply` 1, `compound` its compound form), each with or without
// `ccd`; -1 if the query fails.
extern "C" int sf_tile_substep_blocks_per_sm(int apply, int compound,
                                             int ccd) {
  const void* k = nullptr;
  if (!apply)
    k = ccd ? (const void*)tile_project_kernel<true>
            : (const void*)tile_project_kernel<false>;
  else if (compound)
    k = ccd ? (const void*)tile_apply_kernel<true, true>
            : (const void*)tile_apply_kernel<true, false>;
  else
    k = ccd ? (const void*)tile_apply_kernel<false, true>
            : (const void*)tile_apply_kernel<false, false>;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kItemThreads,
                                                    0) != cudaSuccess)
    return -1;
  return blocks;
}

// Resident blocks of K7 an SM (256 threads); -1 if the query fails.
extern "C" int sf_tile_ccd_blocks_per_sm() {
  int blocks = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, tile_ccd_kernel, kItemThreads, 0) == cudaSuccess
             ? blocks
             : -1;
}

extern "C" int sf_tile_ccd(const TileCcdArgs* a, void* stream) {
  const dim3 grid(kRowGroups, a->Nt);
  if (a->Nt > 0)
    tile_ccd_kernel<<<grid, kItemThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
