// All the substeps of a tile-engine frame in one launch: for each substep,
// project over every row, a grid-wide barrier, apply over every row, and a
// barrier before the next substep reads the new state.
//
// Replaces starframe_tpu/pallas/tiles.py `_mega_kernel` (via `_run_mega`),
// which runs the same substeps x (project, apply) as the sequential grid
// of one pallas_call with the state double-buffered in VMEM. Here the
// phases are separated by `cooperative_groups::this_grid().sync()` in one
// cooperative launch (2 x substeps - 1 barriers), and each phase runs the
// (row, slot) bodies of K8 and K9 (`project_group`, `apply_group` in
// tile_rows.cuh) over every row group, so a frame is bitwise equal to the
// per-substep pair of tile_substep.cu. The state ping-pongs between two
// global buffers (tile_frame.cuh). A skipped tile (tile_live = 0) still
// zeroes its corrections and copies its state into the other buffer;
// `touched` is max-accumulated by its own row's item only. Integer
// barriers, no atomics on floats: reruns are bitwise equal.
//
// With CCD (the kCcd instance, tiles.py `_mega_kernel` with `ccd`: three
// phases a substep) each substep starts with K7's body (`ccd_group`, the
// same (row, slot) items over every row group) writing every row's TOI
// factor into the `ccd.f` scratch (1 on a skipped tile and a row that is
// not a bullet, as `_run_mega`'s ones), then a barrier, then the project
// and apply phases' kCcd forms read it: bitwise equal to K7, K8 and K9
// launched once a substep.
//
// What bounds it on an H100: bytes, as K8/K9, and the barriers. Each
// substep reads the solve tables (7.2 MB at the 10k pile) and the state
// and correction windows; the frame's working set (~10 MB) sits in the
// 50 MB L2. What held the row-loop design back was latency: one thread
// walked its row's Cs slots in series, at ~2.4 warps an SM. Design: the
// compound frame's without its owner phases. 256 threads a block, a work
// unit of every phase is 32 rows x 8 slot items (K7's, K8's and K9's
// block); as many blocks as fit on the card at once (the occupancy query
// times the SM count, at most the row phases' units), each looping over
// units. No register cap: at 122 registers two
// blocks fit an SM; capped at 80 for three, it spilled 272 B and, measured
// alone in turns on an H100, ran 0.164 against 0.194 ms at the awake pile
// but 0.193 against 0.152 at the settled compound pile's layout and its
// CCD form 0.305 against 0.252 (tools/tile_substep_times.py).

#include <cooperative_groups.h>

#include "tile_frame.cuh"
#include "tile_rows.cuh"

namespace cg = cooperative_groups;

namespace {

template <bool kCcd>
__global__ void __launch_bounds__(kItemThreads)
    tile_frame_kernel(TileFrameArgs f) {
  __shared__ GroupShared sh;
  cg::grid_group grid = cg::this_grid();
  const int Nt = f.project.Nt;
  const int groups = Nt * kRowGroups;  // units of the row phases
  for (int s = 0; s < f.substeps; ++s) {
    const int src = state_src(s);
    const int odd = s & 1;
    TileProjectArgs p = f.project;
    p.px = state_in(f, src, 0); p.py = state_in(f, src, 1);
    p.an = state_in(f, src, 2); p.vx = state_in(f, src, 3);
    p.vy = state_in(f, src, 4); p.om = state_in(f, src, 5);
    if constexpr (kCcd) {
      TileCcdArgs c = f.ccd;
      c.px = p.px; c.py = p.py; c.an = p.an;
      c.vx = p.vx; c.vy = p.vy; c.om = p.om;
      for (int u = blockIdx.x; u < groups; u += gridDim.x)
        ccd_group(c, u / kRowGroups, u % kRowGroups, sh);
      grid.sync();
    }
    for (int u = blockIdx.x; u < groups; u += gridDim.x)
      project_group<kCcd>(p, u / kRowGroups, u % kRowGroups, sh);
    grid.sync();
    TileApplyArgs a = f.apply;
    a.px = p.px; a.py = p.py; a.an = p.an;
    a.vx = p.vx; a.vy = p.vy; a.om = p.om;
    a.o_px = state_out(f, odd, 0); a.o_py = state_out(f, odd, 1);
    a.o_an = state_out(f, odd, 2); a.o_vx = state_out(f, odd, 3);
    a.o_vy = state_out(f, odd, 4); a.o_om = state_out(f, odd, 5);
    for (int u = blockIdx.x; u < groups; u += gridDim.x)
      apply_group<false, kCcd>(a, u / kRowGroups, u % kRowGroups, sh);
    if (s + 1 < f.substeps) grid.sync();
  }
}

const void* frame_kernel(bool ccd) {
  return ccd ? (const void*)tile_frame_kernel<true>
             : (const void*)tile_frame_kernel<false>;
}

}  // namespace

SF_EXPORT(sf_tile_frame, TileFrameArgs)

// Resident blocks an SM of K10, with or without CCD; -1 if the query
// fails.
extern "C" int sf_tile_frame_blocks_per_sm(int ccd) {
  return blocks_per_sm(frame_kernel(ccd), kItemThreads);
}

extern "C" int sf_tile_frame(const TileFrameArgs* a, void* stream) {
  static int cached[2][kMaxDevices] = {};  // resident blocks, per instance
  const int groups = a->project.Nt * kRowGroups;
  if (groups == 0 || a->substeps <= 0) return (int)cudaGetLastError();
  const bool ccd = a->ccd.f != nullptr;
  return launch_frame(frame_kernel(ccd), kItemThreads, cached[ccd], groups,
                      a, (cudaStream_t)stream);
}
