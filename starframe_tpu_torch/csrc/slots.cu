// Slot-table broadphase: for every collider row, the first C eligible
// partners whose boxes overlap, ranked touching < margin-close < swept.
//
// Replaces starframe_tpu/pallas/slots.py `_slot_kernel` (launched by
// `build_slot_tables`). Per world it computes each collider's touch, close
// and swept AABBs (optionally the partner-aware two-phase inflation) and
// emits partner/slot_act [W, C, M], count/count_touch/count_close [W, M]
// and the sweep budget [W, M].
//
// What bounds it on an H100: one read of the 268 MB eligibility mask at
// W = 4096, M = 256 (0.08 ms of HBM time), then the M x M pair tests of
// each phase (65,536 per world, ~20 compares and selects each). The TPU
// built a dense f32 [M, M] mask and ranked it with a lower-triangular
// matmul; that is a TPU answer.
//
// Design: one CTA per world (256 threads, 512 past M = 256).
//  * The world's mask slice is streamed from HBM once, with 16-byte loads
//    where rows are aligned, and packed into shared memory as a bit matrix
//    bits[i][k]: bit l of word k says whether partner j = 32k + l may enter
//    row i. A warp packs a 32 x 32 tile: lane l holds row j = 32k + l's 32
//    bytes of i, and one __ballot_sync per i gives row i's word. Rows are
//    padded to an odd number of words so the tile's 32 stores hit 32 banks.
//  * The boxes live in shared memory, a 16-byte (lo x, hi x, lo y, hi y)
//    record each, padded to a whole 32-partner chunk with NaN (which fails
//    every compare), so no lane branches on the tail.
//  * A warp takes two rows (their own boxes are warp-uniform), a lane a
//    partner of each 32-partner chunk: the reference's compares, then
//    __ballot_sync gives each row's touch, close and candidate words. The
//    two rows share the partner's loads and swept box, and their two
//    chains of compares and ballots overlap.
//  * A row skips a chunk when it has no eligible partner there or when its
//    swept box misses the union of the chunk's swept boxes: every skipped
//    pair would fail the swept test that gates all three tiers, so the
//    counts do not change. Lane k tests chunk k, and one ballot gives the
//    chunks to visit; a pair of rows visits the union of theirs (a row
//    finds nothing in a chunk it could skip, the culling being exact).
//  * Ranking needs no sort: lane k keeps chunk k's three tier words (M <=
//    1024 makes at most 32 chunks), and one exclusive warp scan of their
//    popcounts (packed in one word), touch words first, then margin-close,
//    then swept, gives each word's first slot. That is the TPU's `crank`
//    order: tier first, then ascending partner index within a tier. Each
//    lane walks its set bits with __ffs while the slot is below C.
//  * Rows go in rounds of 32; a round's slots are staged in shared memory
//    (double-buffered, one barrier a round), then stored coalesced over i.
//  * Partner-aware mode first runs the same loop as a warp fmaxf reduction
//    (phase 1, order-independent, so `budget` is exact), then recomputes
//    the chunks' union boxes on the inflated sweeps before phase 2.
// No atomics. Empty slots get partner 0 and act 0, which is what the TPU's
// one-hot sums yield.

#include "common.cuh"

namespace {

constexpr int kMaxC = 32;
constexpr int kMaxM = 1024;  // at most 32 chunks: one per lane
constexpr int kPlanes = 11;  // floats a collider: touch 4, close 4, sx, sy, ns
constexpr unsigned kFull = 0xffffffffu;

// The block's shared memory, laid out from its size parameters. A box is
// (lo x, hi x, lo y, hi y), one 16-byte load.
struct Smem {
  float4* tbox;    // touch boxes [Mp]
  float4* cbox;    // close boxes [Mp]
  float2* sweep;   // (sx, sy) [Mp]
  float* ns;       // partner-aware sweep [Mp]
  float4* u1;      // phase 1's chunk union boxes [32]
  float4* u2;      // phase 2's (u1 without partner-aware)
  uint32_t* bits;  // [M][stride] eligibility bits
  int* stage;      // 2 x [C*32 partners, 32 x 3 counts]
  float* sbudget;  // 2 x [32]
};

__host__ __device__ __forceinline__ int n_chunks(int M) {
  return (M + 31) / 32;
}

__host__ __device__ __forceinline__ int bit_stride(int M) {
  const int k = n_chunks(M);
  return k | 1;  // odd: a tile's 32 rows of one word hit 32 banks
}

__host__ __device__ __forceinline__ int stage_ints(int C) {
  return C * 32 + 3 * 32;
}

size_t shared_bytes(int M, int C) {
  const size_t mp = 32 * (size_t)n_chunks(M);
  return kPlanes * mp * sizeof(float) + 2 * 32 * sizeof(float4) +
         (size_t)M * bit_stride(M) * sizeof(uint32_t) +
         2 * (size_t)stage_ints(C) * sizeof(int) + 2 * 32 * sizeof(float);
}

__device__ __forceinline__ bool overlap(float alx, float ahx, float aly,
                                        float ahy, float blx, float bhx,
                                        float bly, float bhy) {
  return (alx <= bhx) && (blx <= ahx) && (aly <= bhy) && (bly <= ahy);
}

__device__ __forceinline__ bool overlap(float4 a, float blx, float bhx,
                                        float bly, float bhy) {
  return overlap(a.x, a.y, a.z, a.w, blx, bhx, bly, bhy);
}

// (min lo x, max hi x, min lo y, max hi y) over the warp's lanes; NaN
// boxes (the tail pads) are ignored by fminf/fmaxf.
__device__ __forceinline__ float4 warp_union(float lx, float hx, float ly,
                                             float hy) {
  for (int o = 16; o > 0; o >>= 1) {
    lx = fminf(lx, __shfl_xor_sync(kFull, lx, o));
    hx = fmaxf(hx, __shfl_xor_sync(kFull, hx, o));
    ly = fminf(ly, __shfl_xor_sync(kFull, ly, o));
    hy = fmaxf(hy, __shfl_xor_sync(kFull, hy, o));
  }
  return make_float4(lx, hx, ly, hy);
}

__device__ __forceinline__ uint32_t warp_inclusive(uint32_t v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Pack elig[j, i] (this world's [M, M] bytes) into s.bits: one warp a
// 32-partner x 32-row tile.
template <bool kVec>
__device__ __forceinline__ void pack_bits(const int8_t* __restrict__ elig,
                                          const Smem& s, int M, int warp,
                                          int n_warps, int lane) {
  const int nch = n_chunks(M), stride = bit_stride(M);
  for (int q = warp; q < nch * nch; q += n_warps) {
    const int kc = q / nch, i0 = 32 * (q - kc * nch);
    const int j = 32 * kc + lane;
    uint32_t r[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (kVec) {  // M % 16 == 0: i0 and i0 + 16 start aligned 16-byte runs
      if (j < M) {
        const uint4* p =
            reinterpret_cast<const uint4*>(elig + (size_t)j * M + i0);
        const uint4 v0 = __ldg(p);
        r[0] = v0.x; r[1] = v0.y; r[2] = v0.z; r[3] = v0.w;
        if (i0 + 16 < M) {
          const uint4 v1 = __ldg(p + 1);
          r[4] = v1.x; r[5] = v1.y; r[6] = v1.z; r[7] = v1.w;
        }
      }
    } else {
#pragma unroll
      for (int b = 0; b < 32; ++b)
        if (j < M && i0 + b < M)
          r[b >> 2] |=
              (uint32_t)(uint8_t)__ldg(elig + (size_t)j * M + i0 + b)
              << (8 * (b & 3));
    }
    uint32_t mine = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint32_t word =
          __ballot_sync(kFull, ((r[b >> 2] >> (8 * (b & 3))) & 0xffu) != 0);
      if (lane == b) mine = word;
    }
    if (i0 + lane < M) s.bits[(size_t)(i0 + lane) * stride + kc] = mine;
  }
}

// One own row of a warp's pair: its boxes (warp-uniform), its swept box
// in the phase at hand, and lane k's eligibility word of chunk k.
struct Row {
  float4 t, c;           // touch and close boxes
  float lx, hx, ly, hy;  // swept box
  float swx, swy;        // its sweeps
  uint32_t word;
};

// Row i in the phase whose sweeps are ``ns`` (partner-aware phase 2) or
// (sx, sy); a row past M gets NaN boxes and no eligible partner. Returns
// the chunks the row must visit: lane k tests chunk k, which it must when
// the row has an eligible partner there and its swept box meets the
// chunk's union box ``u[k]``.
__device__ __forceinline__ uint32_t load_row(const Smem& s, const float4* u,
                                             int M, int i, bool ns, int lane,
                                             Row& row) {
  const int ic = min(i, M - 1);
  row.t = s.tbox[ic];
  row.c = s.cbox[ic];
  const float2 sw = s.sweep[ic];
  row.swx = ns ? s.ns[ic] : sw.x;
  row.swy = ns ? s.ns[ic] : sw.y;
  row.lx = row.c.x - row.swx;
  row.hx = row.c.y + row.swx;
  row.ly = row.c.z - row.swy;
  row.hy = row.c.w + row.swy;
  row.word = i < M && lane < n_chunks(M)
                 ? s.bits[(size_t)i * bit_stride(M) + lane]
                 : 0u;
  return __ballot_sync(kFull, row.word != 0 && overlap(u[lane], row.lx,
                                                       row.hx, row.ly,
                                                       row.hy));
}

// Phase 1 for rows a and b (b may lie past M): the largest sweep over each
// row's eligible partners whose swept boxes overlap its own; sets ns[a],
// ns[b]. The two rows share each visited chunk's partner loads; a row that
// would have skipped the chunk finds no partner there (the culling is
// exact), so visiting the union of their chunks changes nothing.
__device__ __forceinline__ void phase1_rows(const Smem& s, int M, int a,
                                            int b, int lane) {
  Row ra, rb;
  uint32_t todo = load_row(s, s.u1, M, a, false, lane, ra) |
                  load_row(s, s.u1, M, b, false, lane, rb);
  float pa = 0.f, pb = 0.f;
  while (todo != 0) {
    const int k = __ffs(todo) - 1;
    todo &= todo - 1;
    const uint32_t wa = __shfl_sync(kFull, ra.word, k);
    const uint32_t wb = __shfl_sync(kFull, rb.word, k);
    const int j = 32 * k + lane;
    const float4 cj = s.cbox[j];
    const float2 wj = s.sweep[j];
    const float lx = cj.x - wj.x, hx = cj.y + wj.x;
    const float ly = cj.z - wj.y, hy = cj.w + wj.y;
    if (((wa >> lane) & 1u) && overlap(lx, hx, ly, hy, ra.lx, ra.hx, ra.ly,
                                       ra.hy))
      pa = fmaxf(pa, wj.x);
    if (((wb >> lane) & 1u) && overlap(lx, hx, ly, hy, rb.lx, rb.hx, rb.ly,
                                       rb.hy))
      pb = fmaxf(pb, wj.x);
  }
  for (int o = 16; o > 0; o >>= 1) {
    pa = fmaxf(pa, __shfl_xor_sync(kFull, pa, o));
    pb = fmaxf(pb, __shfl_xor_sync(kFull, pb, o));
  }
  if (lane == 0) {
    s.ns[a] = fmaxf(ra.swx, pa);
    if (b < M) s.ns[b] = fmaxf(rb.swx, pb);
  }
}

// Lane k holds chunk k's touch, close and swept words of a row: rank them
// into the row's first C slots (round row r of the stage) and its counts.
__device__ __forceinline__ void rank_row(uint32_t mt, uint32_t mc,
                                         uint32_t ms, float budget, int C,
                                         int r, int* stage, float* sbudget,
                                         int lane) {
  // tiers: touch; close and not touch; swept and neither. A row has at most
  // M - 1 <= 1023 candidates (a collider is never its own partner), so the
  // three popcounts scan packed in one word: 11, 11 and 10 bits.
  const uint32_t mm = mc & ~mt, mf = ms & ~(mt | mc);
  const uint32_t packed = __popc(mt) | __popc(mm) << 11 | __popc(mf) << 22;
  const uint32_t incl = warp_inclusive(packed, lane), excl = incl - packed;
  const uint32_t tot = __shfl_sync(kFull, incl, 31);
  const int nt = tot & 2047, nm = (tot >> 11) & 2047, nf = tot >> 22;
  const int first[3] = {(int)(excl & 2047), nt + (int)((excl >> 11) & 2047),
                        nt + nm + (int)(excl >> 22)};
  const uint32_t words[3] = {mt, mm, mf};
#pragma unroll
  for (int tier = 0; tier < 3; ++tier) {
    uint32_t w = words[tier];
    for (int sl = first[tier]; w != 0 && sl < C; ++sl) {
      stage[sl * 32 + r] = 32 * lane + __ffs(w) - 1;
      w &= w - 1;
    }
  }
  const int ncl = (int)__reduce_add_sync(kFull, (unsigned)__popc(mc));
  if (lane == 0) {
    int* cnt = stage + C * 32;
    cnt[r] = nt + nm + nf;
    cnt[32 + r] = nt;
    cnt[64 + r] = ncl;
    sbudget[r] = budget;
  }
}

// Phase 2 for rows i0 + a and i0 + b (round rows a and b; b may lie past
// M): tiers, counts and the first C slots, into the round's stage. The
// rows share each visited chunk's partner loads, as in phase 1.
__device__ __forceinline__ void phase2_rows(const Smem& s, int M, int C,
                                            bool pa, int i0, int a, int b,
                                            int* stage, float* sbudget,
                                            int lane) {
  Row ra, rb;
  uint32_t todo = load_row(s, s.u2, M, i0 + a, pa, lane, ra) |
                  load_row(s, s.u2, M, i0 + b, pa, lane, rb);
  uint32_t ta = 0, ca = 0, sa = 0, tb = 0, cb = 0, sb = 0;  // lane k: chunk k
  while (todo != 0) {
    const int k = __ffs(todo) - 1;
    todo &= todo - 1;
    const uint32_t wa = __shfl_sync(kFull, ra.word, k);
    const uint32_t wb = __shfl_sync(kFull, rb.word, k);
    const int j = 32 * k + lane;
    const float4 cj = s.cbox[j];
    float wx, wy;
    if (pa) {
      wx = wy = s.ns[j];
    } else {
      const float2 wj = s.sweep[j];
      wx = wj.x;
      wy = wj.y;
    }
    const float lx = cj.x - wx, hx = cj.y + wx;
    const float ly = cj.z - wy, hy = cj.w + wy;
    const bool swa = ((wa >> lane) & 1u) &&
                     overlap(lx, hx, ly, hy, ra.lx, ra.hx, ra.ly, ra.hy);
    const bool swb = ((wb >> lane) & 1u) &&
                     overlap(lx, hx, ly, hy, rb.lx, rb.hx, rb.ly, rb.hy);
    const uint32_t cand_a = __ballot_sync(kFull, swa);
    const uint32_t cand_b = __ballot_sync(kFull, swb);
    if ((cand_a | cand_b) == 0) continue;
    const float4 tj = s.tbox[j];
    const uint32_t wta = __ballot_sync(
        kFull, swa && overlap(tj, ra.t.x, ra.t.y, ra.t.z, ra.t.w));
    const uint32_t wca = __ballot_sync(
        kFull, swa && overlap(cj, ra.c.x, ra.c.y, ra.c.z, ra.c.w));
    const uint32_t wtb = __ballot_sync(
        kFull, swb && overlap(tj, rb.t.x, rb.t.y, rb.t.z, rb.t.w));
    const uint32_t wcb = __ballot_sync(
        kFull, swb && overlap(cj, rb.c.x, rb.c.y, rb.c.z, rb.c.w));
    if (lane == k) {
      ta = wta; ca = wca; sa = cand_a;
      tb = wtb; cb = wcb; sb = cand_b;
    }
  }
  rank_row(ta, ca, sa, pa ? ra.swx : fminf(ra.swx, ra.swy), C, a, stage,
           sbudget, lane);
  if (i0 + b < M)
    rank_row(tb, cb, sb, pa ? rb.swx : fminf(rb.swx, rb.swy), C, b, stage,
             sbudget, lane);
}

template <bool kVec>
__global__ void __launch_bounds__(512, 2) slot_kernel(SlotArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M = a.M, N = a.N, V = a.V, C = a.C;
  const bool pa = a.partner_aware != 0;
  const int nch = n_chunks(M), Mp = 32 * nch;
  const size_t w = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  Smem s;  // plain pointer arithmetic: no address is taken, so no stack
  s.tbox = reinterpret_cast<float4*>(smem_raw);
  s.cbox = s.tbox + Mp;
  s.sweep = reinterpret_cast<float2*>(s.cbox + Mp);
  s.ns = reinterpret_cast<float*>(s.sweep + Mp);
  s.u1 = reinterpret_cast<float4*>(s.ns + Mp);  // Mp % 32 == 0: aligned
  s.u2 = pa ? s.u1 + 32 : s.u1;
  s.bits = reinterpret_cast<uint32_t*>(s.u1 + 64);
  s.stage = reinterpret_cast<int*>(s.bits + (size_t)M * bit_stride(M));
  s.sbudget = reinterpret_cast<float*>(s.stage + 2 * stage_ints(C));

  // ---- boxes per collider (NaN past M), phase 1's chunk unions ---------
  const float nan = __int_as_float(0x7fffffff);
  for (int i = tid; i < Mp; i += blockDim.x) {  // whole warps: Mp % 32 == 0
    float tlx = nan, thx = nan, tly = nan, thy = nan;
    float clx = nan, chx = nan, cly = nan, chy = nan, sx = nan, sy = nan;
    if (i < M) {
      const int ob = a.cbody[w * M + i];
      const size_t bo = w * N + ob;
      const float px = a.posx[bo], py = a.posy[bo];
      const float ca = cosf(a.ang[bo]), sa = sinf(a.ang[bo]);
      float lox = 0.f, hix = 0.f, loy = 0.f, hiy = 0.f;
      for (int v = 0; v < V; ++v) {  // padded verts repeat v0: min/max exact
        const float vx = a.vlx[(w * V + v) * M + i];
        const float vy = a.vly[(w * V + v) * M + i];
        const float wx = px + ca * vx - sa * vy;
        const float wy = py + sa * vx + ca * vy;
        lox = v ? fminf(lox, wx) : wx;
        hix = v ? fmaxf(hix, wx) : wx;
        loy = v ? fminf(loy, wy) : wy;
        hiy = v ? fmaxf(hiy, wy) : wy;
      }
      const float r = a.radius[w * M + i];
      const float tp = r + a.tpad, cp = r + a.cpad;
      tlx = lox - tp; thx = hix + tp; tly = loy - tp; thy = hiy + tp;
      clx = lox - cp; chx = hix + cp; cly = loy - cp; chy = hiy + cp;
      sx = fabsf(a.velx[bo]) * a.dt;
      sy = fabsf(a.vely[bo]) * a.dt;
    }
    s.tbox[i] = make_float4(tlx, thx, tly, thy);
    s.cbox[i] = make_float4(clx, chx, cly, chy);
    s.sweep[i] = make_float2(sx, sy);
    s.ns[i] = nan;
    const float4 u = warp_union(clx - sx, chx + sx, cly - sy, chy + sy);
    if (lane == 0) s.u1[i >> 5] = u;
  }
  pack_bits<kVec>(a.elig + w * M * M, s, M, warp, n_warps, lane);
  __syncthreads();

  if (pa) {
    // phase 1: who can reach collider i within the window at current
    // speeds; inflate i's (symmetric) sweep to the max over them
    for (int i = warp; i < M; i += 2 * n_warps)
      phase1_rows(s, M, i, i + n_warps, lane);
    __syncthreads();
    for (int k = warp; k < nch; k += n_warps) {
      const int j = 32 * k + lane;
      const float n = s.ns[j];
      const float4 c = s.cbox[j];
      const float4 u = warp_union(c.x - n, c.y + n, c.z - n, c.w + n);
      if (lane == 0) s.u2[k] = u;
    }
    __syncthreads();
  }

  // ---- rank and select, 32 rows a round --------------------------------
  for (int i0 = 0, q = 0; i0 < M; i0 += 32, ++q) {
    int* stage = s.stage + (q & 1) * stage_ints(C);
    float* sbudget = s.sbudget + (q & 1) * 32;
    for (int r = warp; r < 32 && i0 + r < M; r += 2 * n_warps)
      phase2_rows(s, M, C, pa, i0, r, r + n_warps, stage, sbudget, lane);
    __syncthreads();  // the other buffer's stores ended before this barrier
    const int* cnt = stage + C * 32;
    for (int e = tid; e < C * 32; e += blockDim.x) {
      const int c = e >> 5, r = e & 31, i = i0 + r;
      if (i >= M) continue;
      const bool on = c < cnt[r];  // count >= C fills every slot
      const size_t o = (w * C + c) * M + i;
      a.partner[o] = on ? stage[e] : 0;
      a.slot_act[o] = on ? 1.f : 0.f;
    }
    if (tid < 32 && i0 + tid < M) {
      const size_t row = w * M + i0 + tid;
      a.count[row] = cnt[tid];
      a.count_touch[row] = cnt[32 + tid];
      a.count_close[row] = cnt[64 + tid];
      a.budget[row] = sbudget[tid];
    }
  }
}

template <bool kVec>
int launch(const SlotArgs* a, size_t shmem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      slot_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  const int threads = a->M > 256 ? 512 : 256;
  slot_kernel<kVec><<<a->W, threads, shmem, stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

SF_EXPORT(sf_slots, SlotArgs)

// Dynamic shared memory of one world's block at M colliders, C slots.
extern "C" long long sf_slots_shared_bytes(int M, int C) {
  return (long long)shared_bytes(M, C);
}

// Resident blocks of the kernel an SM at M colliders, C slots (0 on error).
extern "C" int sf_slots_blocks_per_sm(int M, int C) {
  const size_t shmem = shared_bytes(M, C);
  if (cudaFuncSetAttribute(slot_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)shmem) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, slot_kernel<true>, M > 256 ? 512 : 256, shmem) !=
      cudaSuccess)
    return 0;
  return blocks;
}

extern "C" int sf_slots(const SlotArgs* a, void* stream) {
  if (a->C > kMaxC || a->M > kMaxM) return (int)cudaErrorInvalidValue;
  if (a->W <= 0 || a->M <= 0) return (int)cudaGetLastError();
  const size_t shmem = shared_bytes(a->M, a->C);
  const bool vec =
      a->M % 16 == 0 && reinterpret_cast<uintptr_t>(a->elig) % 16 == 0;
  return vec ? launch<true>(a, shmem, (cudaStream_t)stream)
             : launch<false>(a, shmem, (cudaStream_t)stream);
}
