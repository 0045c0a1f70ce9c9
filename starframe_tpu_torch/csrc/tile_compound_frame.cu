// All the substeps of a compound world's tile-engine frame in one launch:
// for each substep, project over every row, the owner sums of its four row
// sums, the apply's compound form, and the owner velocity pass, each phase
// over the whole grid between grid-wide barriers; with CCD, K7's TOI
// factors and their owner minimum come first.
//
// Replaces, for compound rows, the per-substep loop of starframe_tpu/
// pallas/tiles.py `run_tiled_frame` (:2031-2086, under one `lax.scan`):
// `_ccd_kernel` and `_owner_min3` (CCD), `_project_kernel`, `_owner_sum3`
// of its sums, `_apply_kernel(compound=True)` and the owner velocity pass
// (`_owner_shift_reduce`). The JAX package's `_mega_kernel` has no owner
// reductions, so this kernel is the port's own. Each phase runs the row
// bodies of the per-substep kernels (`ccd_group`, `project_group`,
// `apply_group<true>` in tile_rows.cuh; `owner_min_row`, `owner_sum_row`,
// `owner_velocity_row` in owner_rows.cuh), so a frame is bitwise equal to
// tile_substep.cu's and owner_reduce.cu's launches once a substep (six
// phases with CCD, four without, 4 x substeps - 1 or 6 x substeps - 1
// barriers).
//
// Buffers. The state ping-pongs between two global buffers as in K10:
// substep s reads the frame's input (s = 0) or the buffer substep s - 1
// wrote, and its apply phase writes the other one, since it reads its
// partners' pre-apply state from the 3-tile window while other blocks
// write theirs. The owner sums have a buffer of their own (`osum`): a row's
// sum reads its siblings' raw sums, which may lie in another block. The
// owner velocity pass writes the apply phase's output buffer in place: in
// that phase a row reads vx, vy, om at its own row only (the siblings' it
// reads are `accv`'s, which nothing writes then), one thread reads and
// writes each, and the barrier after it orders those writes before the
// next substep's reads. With CCD the raw factors go to `frame.ccd.f` and
// their owner minimum to `f_own`, which the project and apply phases
// read. `touched` is max-accumulated by its own row's item only. Integer
// barriers, no atomics on floats: reruns are bitwise equal.
//
// What bounds it on an H100: bytes, as K8/K9, and the barriers. Each
// substep reads the solve tables and the state and correction windows; the
// frame's working set (~15 MB at the compound pile) sits in the 50 MB L2.
// 256 threads a block as K8/K9 (a work unit of the row phases, CCD's too,
// is 32 rows x 8 slot items, of the owner phases 256 rows, a thread each), as
// many blocks as fit on the card at once (the occupancy query times the
// SM count, at most the row phases' units), each looping over units. No
// register cap, unlike K8/K9's: at two blocks an SM the grid barriers cost
// less than the third block's work saves (measured in turns at the
// compound pile's states).

#include <cooperative_groups.h>

#include "owner_rows.cuh"
#include "tile_frame.cuh"
#include "tile_rows.cuh"

namespace cg = cooperative_groups;

namespace {

template <bool kCcd>
__global__ void __launch_bounds__(kItemThreads)
    tile_compound_frame_kernel(TileCompoundFrameArgs c) {
  __shared__ GroupShared sh;
  cg::grid_group grid = cg::this_grid();
  const TileFrameArgs& f = c.frame;
  const int Nt = f.project.Nt;
  const int n = Nt * kT;  // rows
  const int groups = Nt * kRowGroups;  // units of the row phases
  const size_t plane = (size_t)n;
  for (int s = 0; s < f.substeps; ++s) {
    const int src = state_src(s);
    const int odd = s & 1;
    TileProjectArgs p = f.project;
    p.px = state_in(f, src, 0); p.py = state_in(f, src, 1);
    p.an = state_in(f, src, 2); p.vx = state_in(f, src, 3);
    p.vy = state_in(f, src, 4); p.om = state_in(f, src, 5);
    if constexpr (kCcd) {
      TileCcdArgs k = f.ccd;
      k.px = p.px; k.py = p.py; k.an = p.an;
      k.vx = p.vx; k.vy = p.vy; k.om = p.om;
      for (int u = blockIdx.x; u < groups; u += gridDim.x)
        ccd_group(k, u / kRowGroups, u % kRowGroups, sh);
      grid.sync();
      // a compound advances by its earliest row's clamp
      for (int u = blockIdx.x; u < Nt; u += gridDim.x) {
        const int i = u * kT + threadIdx.x;
        c.f_own[i] = owner_min_row(k.f, c.ob, i, n, c.kc);
      }
      grid.sync();
    }
    for (int u = blockIdx.x; u < groups; u += gridDim.x)
      project_group<kCcd>(p, u / kRowGroups, u % kRowGroups, sh);
    grid.sync();
    const float* raw[4] = {p.dxx, p.dxy, p.dth, p.cnt};
    for (int u = blockIdx.x; u < Nt; u += gridDim.x) {
      const int i = u * kT + threadIdx.x;
      for (int q = 0; q < 4; ++q)
        c.osum[q * plane + i] = owner_sum_row(raw[q], c.ob, i, n, c.kc);
    }
    grid.sync();
    TileApplyArgs a = f.apply;
    a.px = p.px; a.py = p.py; a.an = p.an;
    a.vx = p.vx; a.vy = p.vy; a.om = p.om;
    a.o_px = state_out(f, odd, 0); a.o_py = state_out(f, odd, 1);
    a.o_an = state_out(f, odd, 2); a.o_vx = state_out(f, odd, 3);
    a.o_vy = state_out(f, odd, 4); a.o_om = state_out(f, odd, 5);
    for (int u = blockIdx.x; u < groups; u += gridDim.x)
      apply_group<true, kCcd>(a, u / kRowGroups, u % kRowGroups, sh);
    grid.sync();
    OwnerVelocityArgs v;
    v.vx = a.o_vx; v.vy = a.o_vy; v.om = a.o_om;
    v.accv = a.accv; v.ob = c.ob;
    v.o_vx = a.o_vx; v.o_vy = a.o_vy; v.o_om = a.o_om;  // in place
    v.n = n; v.kc = c.kc;
    v.lin_sdamp = a.lin_sdamp; v.ang_sdamp = a.ang_sdamp;
    v.use_lin_damp = a.use_lin_damp; v.use_ang_damp = a.use_ang_damp;
    for (int u = blockIdx.x; u < Nt; u += gridDim.x)
      owner_velocity_row(v, u * kT + threadIdx.x);
    if (s + 1 < f.substeps) grid.sync();
  }
}

const void* compound_frame_kernel(bool ccd) {
  return ccd ? (const void*)tile_compound_frame_kernel<true>
             : (const void*)tile_compound_frame_kernel<false>;
}

}  // namespace

SF_EXPORT(sf_tile_compound_frame, TileCompoundFrameArgs)

// Resident blocks an SM of the compound frame, with or without CCD; -1 if
// the query fails.
extern "C" int sf_tile_compound_frame_blocks_per_sm(int ccd) {
  return blocks_per_sm(compound_frame_kernel(ccd), kItemThreads);
}

extern "C" int sf_tile_compound_frame(const TileCompoundFrameArgs* a,
                                      void* stream) {
  static int cached[2][kMaxDevices] = {};  // resident blocks, per instance
  const int groups = a->frame.project.Nt * kRowGroups;
  if (groups == 0 || a->frame.substeps <= 0) return (int)cudaGetLastError();
  if (a->kc < 1) return (int)cudaErrorInvalidValue;
  const bool ccd = a->f_own != nullptr;
  return launch_frame(compound_frame_kernel(ccd), kItemThreads, cached[ccd],
                      groups, a, (cudaStream_t)stream);
}
