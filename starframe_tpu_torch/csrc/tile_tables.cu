// Tile tables: for every row of a tile, the first C eligible candidates of
// its 3-tile window and the large set whose boxes overlap, ranked touching
// < margin-close < swept, plus counts, the window-miss flag and the sweep
// budget clamped to the window's coverage.
//
// Replaces starframe_tpu/pallas/tiles.py `_tables_kernel` (launched by
// `build_tile_tables`). The TPU built a dense f32 [S, T] mask per tile
// (S = 3T + L = 896 candidates) and ranked it with three [S, S] x [S, T]
// lower-triangular matmuls; on Hopper that mask is 896 KB a tile, far past
// a block's shared memory, and the matmul is a TPU answer.
//
// What bounds it on an H100: the pair tests, S x T = 229,376 a tile (~20
// compares each), about 9.2e6 at the 10k pile's 40 tiles; the bytes are
// small (the state and consts, ~1 MB). Design: one block per tile, one
// thread per own row (K2's design, csrc/slots.cu). The block first computes
// every candidate's touch, close and swept boxes and its flags into shared
// memory (18 words x 896 = 65 KB), so the scan reads them as warp-wide
// broadcasts; each thread then scans the candidates in index order and keeps
// the first C of each tier in local arrays, then merges the tiers touch ->
// close -> swept into its C slots: exactly the TPU's `crank` order (tier
// first, ascending candidate index within a tier). Empty slots get index 0
// and act 0, what the TPU's one-hot sums yield. cosf/sinf without fast math
// and -fmad=false keep every box bit-equal to the plain twin's, so the
// integer outputs are equal.

#include "common.cuh"

namespace {

constexpr int kT = TILE_T;
constexpr int kS = TILE_WIN * TILE_T + TILE_L;
constexpr int kMaxC = 32;
constexpr int kFields = 18;  // 15 float and 3 int planes of [S]

struct Cand {
  float *tlx, *thx, *tly, *thy;  // touch boxes
  float *clx, *chx, *cly, *chy;  // close boxes
  float *slx, *shx, *sly, *shy;  // swept boxes
  float *swx, *part, *act;       // sort-axis sweep, moves / active flags
  int *lay, *msk;                // layer and mask bits
};

__device__ __forceinline__ bool overlap(const float* lx, const float* hx,
                                        const float* ly, const float* hy,
                                        int j, int o) {
  return (lx[j] <= hx[o]) && (lx[o] <= hx[j]) && (ly[j] <= hy[o]) &&
         (ly[o] <= hy[j]);
}

__global__ void __launch_bounds__(kT) tile_tables_kernel(TileTablesArgs a) {
  extern __shared__ float smem[];
  const int t = blockIdx.x, Nt = a.Nt, V = a.V, C = a.C;
  const int start = max(min(t - 1, Nt - TILE_WIN), 0);
  const int own = t - start;
  Cand s;
  float* p = smem;
  float** fields[] = {&s.tlx, &s.thx, &s.tly, &s.thy, &s.clx, &s.chx,
                      &s.cly, &s.chy, &s.slx, &s.shx, &s.sly, &s.shy,
                      &s.swx, &s.part, &s.act};
  for (float** f : fields) {
    *f = p;
    p += kS;
  }
  s.lay = reinterpret_cast<int*>(p);
  s.msk = s.lay + kS;
  int* ob = s.msk + kS;  // owner body (sibling exclusion); -1 large

  const float gx = a.gravity[0], gy = a.gravity[1];
  const float gmag = sqrtf(gx * gx + gy * gy);

  // ---- candidate boxes -------------------------------------------------
  for (int j = threadIdx.x; j < kS; j += blockDim.x) {
    const int r = tile_candidate(t, Nt, j);
    float px, py, an, vx, vy, rad, part, act;
    int lay, msk, obj;
    const float *vlx, *vly;
    int vstride;
    if (r >= 0) {
      px = a.px[r]; py = a.py[r]; an = a.an[r]; vx = a.vx[r]; vy = a.vy[r];
      rad = a.rad[r];
      part = a.mov[r];  // window candidates must move: statics ride the
      act = a.act[r];   // large channel only
      lay = a.lay[r]; msk = a.msk[r]; obj = a.obody[r];
      const int rt = r / kT, lane = r % kT;
      vlx = a.vlx + (size_t)rt * V * kT + lane;
      vly = a.vly + (size_t)rt * V * kT + lane;
      vstride = kT;
    } else {
      const int l = -1 - r;
      px = a.l_px[l]; py = a.l_py[l]; an = a.l_an[l]; vx = 0.f; vy = 0.f;
      rad = a.l_rad[l];
      part = a.l_act[l];
      act = a.l_act[l];
      lay = a.l_lay[l]; msk = a.l_msk[l]; obj = -1;
      vlx = a.l_vlx + l;
      vly = a.l_vly + l;
      vstride = TILE_L;
    }
    const float ca = cosf(an), sa = sinf(an);
    float lox = 0.f, hix = 0.f, loy = 0.f, hiy = 0.f, ext = 0.f;
    for (int v = 0; v < V; ++v) {  // padded verts repeat v0: min/max exact
      const float x = vlx[v * vstride], y = vly[v * vstride];
      const float wx = px + ca * x - sa * y;
      const float wy = py + sa * x + ca * y;
      const float d = sqrtf(x * x + y * y);
      lox = v ? fminf(lox, wx) : wx;
      hix = v ? fmaxf(hix, wx) : wx;
      loy = v ? fminf(loy, wy) : wy;
      hiy = v ? fmaxf(hiy, wy) : wy;
      ext = v ? fmaxf(ext, d) : d;
    }
    ext = ext + rad;
    float swx, swy;
    if (a.sweep_frames > 1) {
      // K-frame symmetric speed sweep, capped at sweep_cap extents
      const float spd = sqrtf(vx * vx + vy * vy);
      const float sw = fminf((spd + gmag * a.dt + a.sweep_slack) * a.kdt +
                                 a.sweep_floor * ext,
                             a.sweep_cap * ext) *
                       (part > 0.f ? 1.f : 0.f);
      swx = swy = sw;
    } else {
      swx = fabsf(vx) * a.dt;
      swy = fabsf(vy) * a.dt;
    }
    const float tp = rad + a.tpad, cp = rad + a.cpad;
    s.tlx[j] = lox - tp; s.thx[j] = hix + tp;
    s.tly[j] = loy - tp; s.thy[j] = hiy + tp;
    const float clx = lox - cp, chx = hix + cp, cly = loy - cp, chy = hiy + cp;
    s.clx[j] = clx; s.chx[j] = chx; s.cly[j] = cly; s.chy[j] = chy;
    s.slx[j] = clx - swx; s.shx[j] = chx + swx;
    s.sly[j] = cly - swy; s.shy[j] = chy + swy;
    s.swx[j] = swx;
    s.part[j] = part;
    s.act[j] = act;
    s.lay[j] = lay;
    s.msk[j] = msk;
    ob[j] = obj;
  }
  __syncthreads();

  // ---- rank and select, one own row per thread ---------------------------
  const int i = threadIdx.x;
  const int o = own * kT + i;  // the row's own candidate index
  const int row = t * kT + i;
  const float c_lo = a.sort_axis == 0 ? s.clx[o] : s.cly[o];
  const float c_hi = a.sort_axis == 0 ? s.chx[o] : s.chy[o];
  const float e_lo = a.edge_lo[t], e_hi = a.edge_hi[t];
  const float avail = fminf(e_hi - c_hi, c_lo - e_lo);
  a.sweep[row] = fminf(s.swx[o], fmaxf(avail, 0.f));
  const bool responds = a.responds[row] > 0.f;
  a.winover[row] = ((c_lo < e_lo) || (c_hi > e_hi)) && responds ? 1 : 0;
  // rows: responding colliders and moving sensors
  const bool row_ok = responds || (a.sen[row] > 0.f && s.part[o] > 0.f);
  const int o_lay = s.lay[o], o_msk = s.msk[o], o_ob = ob[o];
  int lt[kMaxC], lm[kMaxC], lf[kMaxC];
  int nt = 0, nm = 0, nf = 0, ncl = 0;
  if (row_ok) {
    for (int j = 0; j < kS; ++j) {
      if (!(s.part[j] > 0.f && s.act[j] > 0.f)) continue;
      if (j == o || ob[j] == o_ob) continue;
      if (!(((o_msk >> s.lay[j]) & 1) && ((s.msk[j] >> o_lay) & 1))) continue;
      if (!overlap(s.slx, s.shx, s.sly, s.shy, j, o)) continue;
      const bool touch = overlap(s.tlx, s.thx, s.tly, s.thy, j, o);
      const bool close = overlap(s.clx, s.chx, s.cly, s.chy, j, o);
      ncl += close;
      if (touch) {
        if (nt < C) lt[nt] = j;
        ++nt;
      } else if (close) {
        if (nm < C) lm[nm] = j;
        ++nm;
      } else {
        if (nf < C) lf[nf] = j;
        ++nf;
      }
    }
  }
  int k = 0;
  const size_t base = (size_t)t * C * kT + i;
  for (int q = 0; q < nt && k < C; ++q, ++k) {
    a.pidx[base + (size_t)k * kT] = lt[q];
    a.act_o[base + (size_t)k * kT] = 1.f;
  }
  for (int q = 0; q < nm && k < C; ++q, ++k) {
    a.pidx[base + (size_t)k * kT] = lm[q];
    a.act_o[base + (size_t)k * kT] = 1.f;
  }
  for (int q = 0; q < nf && k < C; ++q, ++k) {
    a.pidx[base + (size_t)k * kT] = lf[q];
    a.act_o[base + (size_t)k * kT] = 1.f;
  }
  for (; k < C; ++k) {
    a.pidx[base + (size_t)k * kT] = 0;
    a.act_o[base + (size_t)k * kT] = 0.f;
  }
  a.count[row] = nt + nm + nf;
  a.count_touch[row] = nt;
  a.count_close[row] = ncl;
}

}  // namespace

SF_EXPORT(sf_tile_tables, TileTablesArgs)

extern "C" long long sf_tile_tables_shared_bytes() {
  return (long long)kFields * kS * 4;
}

extern "C" int sf_tile_tables(const TileTablesArgs* a, void* stream) {
  if (a->C > kMaxC) return (int)cudaErrorInvalidValue;
  const size_t shmem = (size_t)kFields * kS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tile_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  if (a->Nt > 0)
    tile_tables_kernel<<<a->Nt, kT, shmem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
