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
// What bounds it on an H100: the pair tests. Dense, S x T = 229,376 a tile
// (~20 compares each), 9.2e6 at the 10k pile's 40 tiles; the bytes are
// small (the state and consts, ~1 MB). Most pairs are far apart: rows are
// sorted along the sort axis, so a row meets a few window chunks and the
// large set's occupied ones. Design (K2's, csrc/slots.cu):
//  * A tile is 8 blocks of 32 rows (320 blocks at 40 tiles; 4 fit an SM at
//    64 registers). Each block computes every candidate's hull AABB,
//    radius, sweeps, layer, mask and owner into shared memory (41 KB with
//    the stage), with the plain twin's expressions in its order, so the
//    boxes are bit-equal to its; the touch, close and swept bounds are
//    formed at each test from them with those expressions. One ballot a
//    32-candidate chunk gives its eligible candidates (moving window rows,
//    active large-set slots) and a warp reduction their union swept box.
//    Measured in turns on an H100 (tools/tile_substep_times.py): 16 rows a
//    block ran 26-40 us against 19-33 at the piles' states (the candidate
//    work twice over); 64 rows 10-16% slower on the 40-tile piles, 0-5%
//    faster on the 79-tile compound pile; issuing a candidate's vertex
//    loads together took 3-9% off.
//  * A warp takes two neighbouring rows (their boxes are warp-uniform), a
//    lane a candidate of each 32-candidate chunk: the reference's tests,
//    then ballots give each row's swept, touch and close words. The rows
//    share the candidate's loads.
//  * A row skips a chunk whose union swept box misses its own swept box:
//    the touch box lies inside the close box inside the swept box, and
//    all three tiers need the swept overlap, so nothing it skips could
//    enter its table. Lane k tests chunk k (28 chunks), and one ballot
//    gives the chunks to visit; a pair of rows visits the union of theirs.
//  * Ranking needs no sort: lane c keeps chunk c's words, and one
//    exclusive warp scan of their popcounts (packed in one word: touch,
//    close-not-touch, swept-only) gives each word's first slot, the TPU's
//    `crank` order (tier first, ascending candidate index within a tier).
//    Each lane walks its set bits with __ffs while the slot is below C,
//    into a [C, 32] stage in shared memory, stored coalesced over rows.
// Empty slots get index 0 and act 0, what the TPU's one-hot sums yield.
// cosf/sinf without fast math and -fmad=false keep every box bit-equal to
// the plain twin's, so the integer outputs are equal. No atomics.

#include "common.cuh"

namespace {

constexpr int kT = TILE_T;
constexpr int kS = TILE_WIN * TILE_T + TILE_L;  // candidates a tile
constexpr int kChunks = kS / 32;
static_assert(kS % 32 == 0 && kChunks <= 32, "a lane per candidate chunk");
constexpr int kMaxC = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;  // own rows a block
constexpr int kVertBatch = 8;  // a candidate's vertex loads in flight
constexpr int kBlocksPerTile = kT / kRows;

struct Shared {
  float4 hull[kS];  // lo x, hi x, lo y, hi y of the hull's world AABB
  float4 pad[kS];   // radius, sweep x, sweep y, layer (int bits)
  int2 ids[kS];     // layer mask, owner body (-1 on the large set)
  uint32_t elig[kChunks];  // moving / active candidates, a bit each
  float4 uni[kChunks];     // union swept box of a chunk's eligible ones
  int slot[kMaxC][kRows + 1];  // the rows' selected candidates
  int count[3][kRows];         // count, count_touch, count_close
};

// A candidate's touch, close and swept boxes, each (lo x, hi x, lo y,
// hi y), formed as the reference forms them.
struct Boxes {
  float4 t, c, s;
};

__device__ __forceinline__ Boxes boxes(float4 h, float4 p, float tpad,
                                       float cpad) {
  const float rad = p.x, swx = p.y, swy = p.z;
  const float tp = rad + tpad, cp = rad + cpad;
  Boxes b;
  b.t = make_float4(h.x - tp, h.y + tp, h.z - tp, h.w + tp);
  b.c = make_float4(h.x - cp, h.y + cp, h.z - cp, h.w + cp);
  b.s = make_float4(b.c.x - swx, b.c.y + swx, b.c.z - swy, b.c.w + swy);
  return b;
}

// the reference's `overlap(lx, hx, ly, hy, j, o)`: candidate box j, own o
__device__ __forceinline__ bool overlap(float4 j, float4 o) {
  return (j.x <= o.y) && (o.x <= j.y) && (j.z <= o.w) && (o.z <= j.w);
}

// One own row of a warp's pair: its candidate index, boxes and filters
// (warp-uniform), and lane c's words of chunk c.
struct Row {
  int o, lay, msk, ob;
  bool ok;
  Boxes b;
  uint32_t sw, touch, close;
};

__device__ __forceinline__ Row load_row(const Shared& sh,
                                        const TileTablesArgs& a, int own,
                                        int t, int i) {
  Row r;
  const size_t row = (size_t)t * kT + i;
  r.o = own * kT + i;
  const float4 p = sh.pad[r.o];
  r.b = boxes(sh.hull[r.o], p, a.tpad, a.cpad);
  r.lay = __float_as_int(p.w);
  r.msk = sh.ids[r.o].x;
  r.ob = sh.ids[r.o].y;
  // rows: responding colliders and moving sensors
  r.ok = a.responds[row] > 0.f || (a.sen[row] > 0.f && a.mov[row] > 0.f);
  r.sw = r.touch = r.close = 0u;
  return r;
}

// The chunks row r must visit: lane c tests chunk c's union box.
__device__ __forceinline__ uint32_t visits(const Shared& sh, const Row& r,
                                           int lane) {
  return __ballot_sync(kFull, r.ok && lane < kChunks &&
                                  overlap(sh.uni[lane], r.b.s));
}

// Candidate j (eligible) against row r: the swept, touch and close tests
// of the reference, in its order.
__device__ __forceinline__ void test(const Row& r, int j, int lay, int msk,
                                     int ob, const Boxes& b, bool& sw,
                                     bool& touch, bool& close) {
  sw = r.ok && j != r.o && ob != r.ob && ((r.msk >> lay) & 1) &&
       ((msk >> r.lay) & 1) && overlap(b.s, r.b.s);
  touch = sw && overlap(b.t, r.b.t);
  close = sw && overlap(b.c, r.b.c);
}

// Rank row r's words (lane c holds chunk c's) into its C slots of the
// stage, and its counts.
__device__ __forceinline__ void rank_row(Shared& sh, const Row& r, int ri,
                                         int C, int lane) {
  const uint32_t mid = r.close & ~r.touch;
  const uint32_t far = r.sw & ~(r.touch | r.close);
  const uint32_t packed = __popc(r.touch) | (__popc(mid) << 10) |
                          (__popc(far) << 20);
  const uint32_t incl = warp_inclusive(packed, lane);
  const uint32_t total = __shfl_sync(kFull, incl, 31);
  const uint32_t excl = incl - packed;
  const int nt = total & 1023, nm = (total >> 10) & 1023, nf = total >> 20;
  const int ncl = (int)__reduce_add_sync(kFull, (unsigned)__popc(r.close));
  const int base = 32 * lane;
  int k = excl & 1023;
  for (uint32_t m = r.touch; m && k < C; m &= m - 1, ++k)
    sh.slot[k][ri] = base + __ffs(m) - 1;
  k = nt + ((excl >> 10) & 1023);
  for (uint32_t m = mid; m && k < C; m &= m - 1, ++k)
    sh.slot[k][ri] = base + __ffs(m) - 1;
  k = nt + nm + (excl >> 20);
  for (uint32_t m = far; m && k < C; m &= m - 1, ++k)
    sh.slot[k][ri] = base + __ffs(m) - 1;
  if (lane == 0) {
    sh.count[0][ri] = nt + nm + nf;
    sh.count[1][ri] = nt;
    sh.count[2][ri] = ncl;
  }
}

__global__ void __launch_bounds__(kThreads)
    tile_tables_kernel(TileTablesArgs a) {
  __shared__ Shared sh;
  const int t = blockIdx.y, Nt = a.Nt, V = a.V, C = a.C;
  const int i0 = blockIdx.x * kRows;  // the block's first own row
  const int start = max(min(t - 1, Nt - TILE_WIN), 0);
  const int own = t - start;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  const float gx = a.gravity[0], gy = a.gravity[1];
  const float gmag = sqrtf(gx * gx + gy * gy);

  // ---- candidate hulls and chunk unions --------------------------------
  // kS is a multiple of 32, so a warp's lanes are one chunk, all in range
  for (int j = threadIdx.x; j < kS; j += kThreads) {
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
      const int rt = r / kT, rl = r % kT;
      vlx = a.vlx + (size_t)rt * V * kT + rl;
      vly = a.vly + (size_t)rt * V * kT + rl;
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
    // padded verts repeat v0: min/max exact. The loads of kVertBatch
    // vertices go out together, then the reference's fold in vertex order.
    for (int v0 = 0; v0 < V; v0 += kVertBatch) {
      float xs[kVertBatch], ys[kVertBatch];
#pragma unroll
      for (int k = 0; k < kVertBatch; ++k) {
        xs[k] = v0 + k < V ? vlx[(v0 + k) * vstride] : 0.f;
        ys[k] = v0 + k < V ? vly[(v0 + k) * vstride] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kVertBatch; ++k) {
        const int v = v0 + k;
        if (v >= V) break;
        const float x = xs[k], y = ys[k];
        const float wx = px + ca * x - sa * y;
        const float wy = py + sa * x + ca * y;
        const float d = sqrtf(x * x + y * y);
        lox = v ? fminf(lox, wx) : wx;
        hix = v ? fmaxf(hix, wx) : wx;
        loy = v ? fminf(loy, wy) : wy;
        hiy = v ? fmaxf(hiy, wy) : wy;
        ext = v ? fmaxf(ext, d) : d;
      }
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
    const float4 hull = make_float4(lox, hix, loy, hiy);
    const float4 pad = make_float4(rad, swx, swy, __int_as_float(lay));
    sh.hull[j] = hull;
    sh.pad[j] = pad;
    sh.ids[j] = make_int2(msk, obj);
    const bool e = part > 0.f && act > 0.f;
    const uint32_t word = __ballot_sync(kFull, e);
    const float4 s = boxes(hull, pad, a.tpad, a.cpad).s;
    const float inf = __int_as_float(0x7f800000);
    const float4 u = warp_union(e ? s : make_float4(inf, -inf, inf, -inf));
    if (lane == 0) {
      sh.elig[j / 32] = word;
      sh.uni[j / 32] = u;
    }
  }
  __syncthreads();

  // ---- rank and select: a warp a pair of rows, a lane a candidate ------
  for (int q = warp; q < kRows / 2; q += kWarps) {
    const int ri = 2 * q;  // the pair's first row in the block
    Row r0 = load_row(sh, a, own, t, i0 + ri);
    Row r1 = load_row(sh, a, own, t, i0 + ri + 1);
    uint32_t todo = visits(sh, r0, lane) | visits(sh, r1, lane);
    while (todo) {
      const int c = __ffs(todo) - 1;
      todo &= todo - 1;
      const int j = 32 * c + lane;
      bool s0 = false, t0 = false, c0 = false;
      bool s1 = false, t1 = false, c1 = false;
      if ((sh.elig[c] >> lane) & 1) {
        const float4 p = sh.pad[j];
        const int2 ids = sh.ids[j];
        const Boxes b = boxes(sh.hull[j], p, a.tpad, a.cpad);
        const int lay = __float_as_int(p.w);
        test(r0, j, lay, ids.x, ids.y, b, s0, t0, c0);
        test(r1, j, lay, ids.x, ids.y, b, s1, t1, c1);
      }
      const uint32_t ws0 = __ballot_sync(kFull, s0);
      const uint32_t wt0 = __ballot_sync(kFull, t0);
      const uint32_t wc0 = __ballot_sync(kFull, c0);
      const uint32_t ws1 = __ballot_sync(kFull, s1);
      const uint32_t wt1 = __ballot_sync(kFull, t1);
      const uint32_t wc1 = __ballot_sync(kFull, c1);
      if (lane == c) {
        r0.sw = ws0; r0.touch = wt0; r0.close = wc0;
        r1.sw = ws1; r1.touch = wt1; r1.close = wc1;
      }
    }
    rank_row(sh, r0, ri, C, lane);
    rank_row(sh, r1, ri + 1, C, lane);
  }
  __syncthreads();

  // ---- coalesced stores over the block's rows ----------------------------
  const size_t tbase = (size_t)t * C * kT + i0;
  for (int q = threadIdx.x; q < C * kRows; q += kThreads) {
    const int k = q / kRows, ri = q % kRows;
    const bool used = k < sh.count[0][ri];
    a.pidx[tbase + (size_t)k * kT + ri] = used ? sh.slot[k][ri] : 0;
    a.act_o[tbase + (size_t)k * kT + ri] = used ? 1.f : 0.f;
  }
  if (threadIdx.x < kRows) {
    const int ri = threadIdx.x, i = i0 + ri;
    const size_t row = (size_t)t * kT + i;
    const int o = own * kT + i;
    const Boxes b = boxes(sh.hull[o], sh.pad[o], a.tpad, a.cpad);
    const float c_lo = a.sort_axis == 0 ? b.c.x : b.c.z;
    const float c_hi = a.sort_axis == 0 ? b.c.y : b.c.w;
    const float e_lo = a.edge_lo[t], e_hi = a.edge_hi[t];
    const float avail = fminf(e_hi - c_hi, c_lo - e_lo);
    a.sweep[row] = fminf(sh.pad[o].y, fmaxf(avail, 0.f));
    const bool responds = a.responds[row] > 0.f;
    a.winover[row] = ((c_lo < e_lo) || (c_hi > e_hi)) && responds ? 1 : 0;
    a.count[row] = sh.count[0][ri];
    a.count_touch[row] = sh.count[1][ri];
    a.count_close[row] = sh.count[2][ri];
  }
}

}  // namespace

SF_EXPORT(sf_tile_tables, TileTablesArgs)

// Resident blocks of K5 an SM (256 threads, static shared memory); -1 if
// the query fails.
extern "C" int sf_tile_tables_blocks_per_sm() {
  int blocks = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, tile_tables_kernel, kThreads, 0) == cudaSuccess
             ? blocks
             : -1;
}

extern "C" int sf_tile_tables(const TileTablesArgs* a, void* stream) {
  if (a->C > kMaxC) return (int)cudaErrorInvalidValue;
  if (a->Nt > 0)
    tile_tables_kernel<<<dim3(kBlocksPerTile, a->Nt), kThreads, 0,
                         (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
