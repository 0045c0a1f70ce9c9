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
// `_mega_kernel`, tile_frame.cu here, is bitwise equal to this pair by
// contract). The per-row bodies (`project_row`, `apply_row`) live in
// tile_rows.cuh, which tile_frame.cu includes too. A non-null `accv` runs
// the apply phase's compound form (`_apply_kernel(compound=True)`): the
// velocity pass's raw sums go out for the caller's owner reduction.
//
// With CCD (cfg.ccd) a third launch comes first: K7 (`sf_tile_ccd`,
// replacing tiles.py `_ccd_kernel` + `_ccd_math`) writes each row's TOI
// factor f, and a non-null `f` in the project and apply arguments runs
// their `kCcd` forms, which scale the pose advance by it. K7 reads what
// K8 reads of a row (its solve slots' masks, anchors and normal, the
// window state) and writes one float a row: bytes again, ~8 MB at the 10k
// pile; one thread per row, 64 a block, as K8.
//
// What bounds it on an H100: bytes. Each launch reads the solve tables
// (22 floats x Cs slots a row: 7.2 MB at the 10k pile's 10,240 rows and
// Cs = 8) plus the state windows and writes ~1 MB: ~9-10 MB, ~3 us at
// 3.35 TB/s; the math is ~100 flops a slot. Design: one thread per row,
// 64 rows a block (160 blocks at 40 tiles: more blocks than SMs), looping
// over the row's Cs solve slots and adding their contributions in slot
// order, as the twin does; the tables are [Nt, field, Cs, T] planes, so
// consecutive threads read consecutive addresses. Partner state is read
// straight from the 3-tile window in global memory (the frame's working
// set, ~10 MB, sits in the 50 MB L2). No atomics: every output has one
// writer, so reruns are bitwise equal. Slots whose solve mask is zero at
// both points add exact zeros in the twin and are skipped.

#include "tile_rows.cuh"

namespace {

constexpr int kRows = 64;  // rows (threads) per block

template <bool kCcd>
__global__ void __launch_bounds__(kRows) tile_project_kernel(
    TileProjectArgs a) {
  const int t = blockIdx.y, i = blockIdx.x * kRows + threadIdx.x;
  if (i < kT) project_row<kCcd>(a, t, i);
}

template <bool kCompound, bool kCcd>
__global__ void __launch_bounds__(kRows) tile_apply_kernel(TileApplyArgs a) {
  const int t = blockIdx.y, i = blockIdx.x * kRows + threadIdx.x;
  if (i < kT) apply_row<kCompound, kCcd>(a, t, i);
}

__global__ void __launch_bounds__(kRows) tile_ccd_kernel(TileCcdArgs a) {
  const int t = blockIdx.y, i = blockIdx.x * kRows + threadIdx.x;
  if (i < kT) ccd_row(a, t, i);
}

template <bool kCompound>
void apply_launch(const TileApplyArgs& a, dim3 grid, cudaStream_t st) {
  if (a.f)
    tile_apply_kernel<kCompound, true><<<grid, kRows, 0, st>>>(a);
  else
    tile_apply_kernel<kCompound, false><<<grid, kRows, 0, st>>>(a);
}

}  // namespace

SF_EXPORT(sf_tile_project, TileProjectArgs)
SF_EXPORT(sf_tile_apply, TileApplyArgs)
SF_EXPORT(sf_tile_ccd, TileCcdArgs)

extern "C" int sf_tile_project(const TileProjectArgs* a, void* stream) {
  const dim3 grid(kT / kRows, a->Nt);
  const cudaStream_t st = (cudaStream_t)stream;
  if (a->Nt > 0) {
    if (a->f)
      tile_project_kernel<true><<<grid, kRows, 0, st>>>(*a);
    else
      tile_project_kernel<false><<<grid, kRows, 0, st>>>(*a);
  }
  return (int)cudaGetLastError();
}

extern "C" int sf_tile_apply(const TileApplyArgs* a, void* stream) {
  const dim3 grid(kT / kRows, a->Nt);
  const cudaStream_t st = (cudaStream_t)stream;
  if (a->Nt > 0) {
    if (a->accv)
      apply_launch<true>(*a, grid, st);
    else
      apply_launch<false>(*a, grid, st);
  }
  return (int)cudaGetLastError();
}

extern "C" int sf_tile_ccd(const TileCcdArgs* a, void* stream) {
  const dim3 grid(kT / kRows, a->Nt);
  if (a->Nt > 0)
    tile_ccd_kernel<<<grid, kRows, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
