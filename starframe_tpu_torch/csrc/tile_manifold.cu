// Tile manifolds: for every row and slot of the tile tables, the frame-start
// manifold with a speed-expanded margin, anchors and normal kept body-local,
// the pair's frame constants; then the solve-slot compaction: the slots with
// a manifold point inside the margin, ranked by live min separation (ties to
// the lower slot), fill the first Cs solve slots.
//
// Replaces starframe_tpu/pallas/tiles.py `_manifold_kernel` (launched by
// `run_tiled_frame`), with its contact-event keys (`with_keys`): given the
// rows' and the large slots' canonical collider ids, each slot's pair key
// min * n_colliders + max is written where its constants go (the raw key of
// every table slot without compaction, zero in a solve slot no active slot
// fills and in a skipped tile, as the TPU kernel writes them). The keys wrap
// as int32 products do, unsigned here; the wrapper refuses a world whose
// real pairs' keys would not fit.
//
// The wake signal adds one rule to the TPU kernel's: a sleeper inside the
// margin of a kinematic partner moving at `sleep_velocity` or faster wakes
// too (the reference wakes only on fast dynamic partners, so a moving
// platform slid out from under a frozen body; ROADMAP.md C).
//
// What bounds it on an H100: the manifold math, ~1-2k flops of scalar
// SAT/clip code per slot (C = 16 slots x 10,240 rows = 1.6e5 manifolds a
// frame at the 10k pile); the bytes (tables in, ~7 MB of solve tables out)
// take ~3 us at 3.35 TB/s. Design: one thread per (row, table slot), so a
// thread holds one manifold's registers (the batched frame kernel's
// <8, true> instance, which holds a whole row's slots in one thread,
// spills); a block is R = 256 / C rows x C slots of one tile (640 blocks at
// C = 16). The per-row rank and the row sums go through shared memory: each
// thread ranks its slot against the row's C keys and, if it is active and
// ranks below Cs, writes its constants straight to solve slot `rank`; the
// solve slots past the row's active count are zero-filled by their own
// thread, so no two threads write one address. The row outputs are summed
// by the slot-0 thread in slot order, as the twin sums them.

#include "common.cuh"
#include "contact.cuh"

namespace {

constexpr int kT = TILE_T;
constexpr int kThreads = 256;
constexpr float kBig = 1e30f;

template <int V>
__global__ void __launch_bounds__(kThreads)
    tile_manifold_kernel(TileManifoldArgs a) {
  extern __shared__ float smem[];
  const int C = a.C, Cs = a.Cs, Nt = a.Nt;
  const int R = blockDim.y;
  const int c = threadIdx.x, r = threadIdx.y;
  const int t = blockIdx.y;
  const int i = blockIdx.x * R + r;
  const bool valid = i < kT;
  float* key = smem;               // [R, C] rank key
  float* hard = key + R * C;       // [R, C] imminent (min sep < margin)
  float* pts = hard + R * C;       // [R, C] undirected manifold points
  float* pen = pts + R * C;        // [R, C] penetration
  float* wk = pen + R * C;         // [R, C] wake signal
  float* am = wk + R * C;          // [R, C] active (any point in margin)
  const int rc = r * C + c;
  const size_t row = (size_t)t * kT + i;
  const size_t splane = (size_t)Cs * kT;          // one solve-table field
  float* sol = a.sol + (size_t)t * TS_FIELDS * splane + i;

  if (!(a.tile_live[t] > 0.f)) {
    // skipped tile (its whole window asleep): zero outputs, no compute
    if (valid && c < Cs) {
      for (int f = 0; f < TS_FIELDS; ++f) sol[f * splane + (size_t)c * kT] = 0.f;
      a.pidx_c[((size_t)t * Cs + c) * kT + i] = 0;
      a.src[((size_t)t * Cs + c) * kT + i] = 0;
      if (a.keyc) a.keyc[((size_t)t * Cs + c) * kT + i] = 0;
    }
    if (valid && c == 0) {
      a.nact[((size_t)t * 2) * kT + i] = 0;
      a.nact[((size_t)t * 2 + 1) * kT + i] = 0;
      a.wake[row] = 0.f; a.pen[row] = 0.f; a.npts[row] = 0.f;
    }
    return;
  }

  float fld[TS_FIELDS];
  int pc = 0, pkey = 0;
  if (valid) {
    // own row: pose, world vertices, speed bound
    const float o_px = a.px[row], o_py = a.py[row], o_an = a.an[row];
    const float o_ca = cosf(o_an), o_sa = sinf(o_an);
    const float o_rad = a.rad[row];
    float vax[V], vay[V], o_ext = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float x = a.vlx[((size_t)t * V + v) * kT + i];
      const float y = a.vly[((size_t)t * V + v) * kT + i];
      vax[v] = o_px + o_ca * x - o_sa * y;
      vay[v] = o_py + o_sa * x + o_ca * y;
      const float d = sqrtf(x * x + y * y);
      o_ext = v ? fmaxf(o_ext, d) : d;
    }
    o_ext = o_ext + o_rad;
    const float ovx = a.vx[row], ovy = a.vy[row], oom = a.om[row];
    const float o_spd = sqrtf(ovx * ovx + ovy * ovy) + fabsf(oom) * o_ext;

    // partner: a window row or a large-set static
    const size_t g = ((size_t)t * C + c) * kT + i;
    pc = a.pidx[g];
    const float act = a.act[g];
    const int pr = tile_candidate(t, Nt, pc);
    float p_px, p_py, p_an, pvx, pvy, pom, p_rad, p_fric, p_rst, p_sen;
    float p_invm, p_invi, p_kin;
    int p_nv;
    float vbx[V], vby[V], p_ext = 0.f;
    const float *pvlx, *pvly;
    int vstride;
    if (pr >= 0) {
      p_px = a.px[pr]; p_py = a.py[pr]; p_an = a.an[pr];
      pvx = a.vx[pr]; pvy = a.vy[pr]; pom = a.om[pr];
      p_rad = a.rad[pr]; p_nv = a.nv[pr]; p_fric = a.fric[pr];
      p_rst = a.rst[pr]; p_sen = a.sen[pr];
      p_invm = a.invm[pr]; p_invi = a.invi[pr]; p_kin = a.kin[pr];
      pvlx = a.vlx + (size_t)(pr / kT) * V * kT + pr % kT;
      pvly = a.vly + (size_t)(pr / kT) * V * kT + pr % kT;
      vstride = kT;
    } else {
      const int l = -1 - pr;
      p_px = a.l_px[l]; p_py = a.l_py[l]; p_an = a.l_an[l];
      pvx = 0.f; pvy = 0.f; pom = 0.f;
      p_rad = a.l_rad[l]; p_nv = a.l_nv[l]; p_fric = a.l_fric[l];
      p_rst = a.l_rst[l]; p_sen = a.l_sen[l];
      p_invm = 0.f; p_invi = 0.f;
      p_kin = 0.f;  // the large set holds statics only (moves == 0)
      pvlx = a.l_vlx + l;
      pvly = a.l_vly + l;
      vstride = TILE_L;
    }
    if (a.keyc) {
      const int32_t oc = a.cid[row];
      const int32_t qc = pr >= 0 ? a.cid[pr] : a.lcid[-1 - pr];
      pkey = (int32_t)((uint32_t)min(oc, qc) * (uint32_t)a.n_colliders
                       + (uint32_t)max(oc, qc));
    }
    const float p_ca = cosf(p_an), p_sa = sinf(p_an);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float x = pvlx[v * vstride], y = pvly[v * vstride];
      vbx[v] = p_px + p_ca * x - p_sa * y;
      vby[v] = p_py + p_sa * x + p_ca * y;
      const float d = sqrtf(x * x + y * y);
      p_ext = v ? fmaxf(p_ext, d) : d;
    }
    p_ext = p_ext + p_rad;
    const float p_spd = sqrtf(pvx * pvx + pvy * pvy) + fabsf(pom) * p_ext;
    // velocity-expanded speculative margin: a contact that forms during the
    // frame's substeps must already be in the manifold
    const float margin_eff = a.margin + a.dt * (o_spd + p_spd);
    Manifold m;
    manifold<V>(vax, vay, a.nv[row], o_rad, vbx, vby, p_nv, p_rad,
                margin_eff, m);
    const float pm0 = m.pmask[0] * act, pm1 = m.pmask[1] * act;
    const bool active = fmaxf(pm0, pm1) > 0.f;
    const float minsep = fminf(pm0 > 0.f ? m.sep[0] : kBig,
                               pm1 > 0.f ? m.sep[1] : kBig);
    const float solvable = act * (1.f - fmaxf(a.sen[row], p_sen));
    fld[TS_ACT] = act;
    fld[TS_NAX] = o_ca * m.nx + o_sa * m.ny;
    fld[TS_NAY] = -o_sa * m.nx + o_ca * m.ny;
    fld[TS_FRIC] = sqrtf(a.fric[row] * p_fric);
    fld[TS_REST] = fmaxf(a.rst[row], p_rst);
    fld[TS_IMB] = p_invm;
    fld[TS_IIB] = p_invi;
    fld[TS_PDYN] = p_invm > 0.f ? 1.f : 0.f;
    const float pm[2] = {pm0, pm1};
    float pen_c = 0.f;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float dxa = m.wax[q] - o_px, dya = m.way[q] - o_py;
      const float dxb = m.wbx[q] - p_px, dyb = m.wby[q] - p_py;
      fld[TS_AAX0 + q] = o_ca * dxa + o_sa * dya;
      fld[TS_AAY0 + q] = -o_sa * dxa + o_ca * dya;
      fld[TS_BAX0 + q] = p_ca * dxb + p_sa * dyb;
      fld[TS_BAY0 + q] = -p_sa * dxb + p_ca * dyb;
      fld[TS_SM0 + q] = pm[q] * solvable;
      fld[TS_PM0 + q] = pm[q];
      fld[TS_SEP0 + q] = m.sep[q];
      pen_c = fmaxf(pen_c, fmaxf(-m.sep[q], 0.f) * pm[q]);
    }
    key[rc] = active ? minsep : kBig;
    am[rc] = active ? 1.f : 0.f;
    hard[rc] = minsep < a.margin ? 1.f : 0.f;
    // undirected points: a window pair appears in both rows
    pts[rc] = (pm0 + pm1) * (pc < TILE_WIN * kT ? 0.5f : 1.f);
    pen[rc] = pen_c;
    float w = 0.f;
    if (a.use_wake) {
      // wake on a fast dynamic partner inside the speculative margin, or
      // on a kinematic one moving at the sleep speed or faster
      const float spd2 = pvx * pvx + pvy * pvy + pom * pom;
      const bool fast_dyn = spd2 >= a.sleep_v2 && p_invm > 0.f;
      const bool fast_kin = spd2 >= a.kin_v2 && p_kin > 0.f;
      const float fast = (fast_dyn || fast_kin) ? 1.f : 0.f;
      w = fmaxf(pm0, pm1) * fast;
    }
    wk[rc] = w;
  }
  __syncthreads();
  if (!valid) return;

  const float* rk = key + r * C;
  const float* ra = am + r * C;
  int n_act = 0, rank = 0;
  const float kc = rk[c];
  for (int k = 0; k < C; ++k) {
    n_act += ra[k] > 0.f;
    rank += (rk[k] < kc) || (rk[k] == kc && k < c);
  }
  int slot = -1;  // the solve slot this table slot fills
  if (Cs >= C)
    slot = c;  // no compaction: solve slots are the table slots
  else if (ra[c] > 0.f && rank < Cs)
    slot = rank;
  if (slot >= 0) {
    for (int f = 0; f < TS_FIELDS; ++f)
      sol[f * splane + (size_t)slot * kT] = fld[f];
    a.pidx_c[((size_t)t * Cs + slot) * kT + i] = pc;
    a.src[((size_t)t * Cs + slot) * kT + i] = c;
    if (a.keyc) a.keyc[((size_t)t * Cs + slot) * kT + i] = pkey;
  }
  if (Cs < C && c < Cs && c >= min(n_act, Cs)) {
    // a solve slot no active table slot fills
    for (int f = 0; f < TS_FIELDS; ++f) sol[f * splane + (size_t)c * kT] = 0.f;
    a.pidx_c[((size_t)t * Cs + c) * kT + i] = 0;
    a.src[((size_t)t * Cs + c) * kT + i] = 0;
    if (a.keyc) a.keyc[((size_t)t * Cs + c) * kT + i] = 0;
  }
  if (c == 0) {
    int n_hard = 0;
    float p_max = 0.f, w_max = 0.f, np = pts[r * C];
    for (int k = 0; k < C; ++k) {
      n_hard += hard[r * C + k] > 0.f && ra[k] > 0.f;
      p_max = fmaxf(p_max, pen[r * C + k]);
      w_max = fmaxf(w_max, wk[r * C + k]);
      if (k) np = np + pts[r * C + k];
    }
    a.nact[((size_t)t * 2) * kT + i] = n_act;
    a.nact[((size_t)t * 2 + 1) * kT + i] = n_hard;
    a.pen[row] = p_max;
    a.wake[row] = w_max;
    a.npts[row] = np;
  }
}

template <int V>
int launch(const TileManifoldArgs& a, cudaStream_t stream) {
  const int R = kThreads / a.C;
  const size_t shmem = (size_t)6 * R * a.C * sizeof(float);
  const dim3 block(a.C, R), grid((kT + R - 1) / R, a.Nt);
  if (a.Nt > 0)
    tile_manifold_kernel<V><<<grid, block, shmem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

SF_EXPORT(sf_tile_manifold, TileManifoldArgs)

extern "C" int sf_tile_solve_fields() { return TS_FIELDS; }

extern "C" int sf_tile_manifold(const TileManifoldArgs* a, void* stream) {
  if (a->C < 1 || a->C > kThreads || a->Cs < 1 || a->Cs > a->C)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (a->V) {  // the wrapper pads vertex rows with copies of v0
    case 4: return launch<4>(*a, st);
    case 8: return launch<8>(*a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
