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
// SAT/clip code per computed slot (at most C = 16 slots x 10,240 rows =
// 1.6e5 manifolds a frame at the 10k pile); the bytes (tables in, ~7 MB of
// solve tables out) take ~3 us at 3.35 TB/s. What held the earlier design
// (a (C, R) block, slot fastest) back: 175 registers, so one 256-thread
// block an SM; strided loads and stores scattered over the solve planes;
// every empty slot computed; the own row recomputed by each of its slots.
//
// Design: rows on lanes. A block is 256 threads, R rows of one tile x
// 256 / R slot lanes, one thread a (row, table slot) item, lane l taking
// the slots l, l + 256 / R, ...: a warp is R consecutive rows of 32 / R
// slots, so its loads of pidx, act and the row planes are whole lines.
// R = 16 (16 lanes) from C = 16 up, else 32 (8 lanes); fewer rows only
// where C is too wide for one block's shared memory.
// Measured alone in turns on an H100 (tools/tile_substep_times.py), 16
// lanes against 8: 37.3 against 41.0 us at the awake pile, 14.2 against
// 22.5 at the sleeping one, 16.0 against 22.1 at the settled compound
// pile, but 74.9 against 64.6 at the busy compound pile (C = 24: the
// second round of 16 lanes half idle); 24 lanes of 8 rows (192 threads,
// 12 warps an SM) took 91.9 there.
// 1. The own row's world vertices, pose and speed bound are computed once a
//    row, by lane 0, into shared memory, with the expressions each slot
//    used before.
// 2. Each item computes its slot's manifold and parks the 22 constants in
//    shared memory. With compaction (Cs < C) a slot whose act is 0 can
//    neither be active nor fill a solve slot: its manifold is skipped, and
//    its row terms are the exact zeros (and the kBig rank key) the full
//    computation gives there. K5 fills a row's slots in order, so the high
//    slots are often empty for whole warps. Without compaction every table
//    slot is written, so every slot computes.
// 3. Each active item ranks its slot against the row's keys (the tie rule
//    above) and records which table slot the solve slot `rank` copies; the
//    row outputs are added by one thread a row in slot order.
// 4. A (row, solve slot) item copies its table slot's parked constants
//    out, or zeros past the row's active count, so a warp's store of a
//    field is whole lines again.
// Shared memory: (22 + 8) x C x R words and 2V + 5 more a row, 32 KB at
// C = 16 and 48 KB at C = 24. Registers bound it at two blocks an SM (16
// warps): with the constants parked and contact.cuh's manifold keeping no
// array of the edges' far ends, <8> fits the cap of 128 with no spills
// (217 uncapped). A table of up to 6 vertex planes (the piles'
// hexagons) runs the <6> instance: the two padded copies of v0 change no
// min, max or selection of the manifold, so its outputs are those of <8>.
// Every output has one writer; every float expression, and the order of
// every sum, are those of the parent design, so outputs are bitwise equal
// to its and reruns are too.

#include "common.cuh"
#include "contact.cuh"

namespace {

constexpr int kT = TILE_T;
constexpr int kThreads = 256;
constexpr int kBlocks = 2;  // resident blocks an SM (at most 128 registers)
constexpr int kOwn = 5;     // own-row terms: px, py, cos, sin, speed bound
constexpr float kBig = 1e30f;

// A block's shared memory at R rows, C table slots, Cs solve slots and V
// vertex planes, in words: each table slot's parked constants [TS_FIELDS,
// C, R]; its rank key, imminent flag, undirected points, penetration,
// wake signal, active flag, partner index and event key [C, R] each; the
// table slot each solve slot copies [Cs, R]; the own row's world vertices
// [2, V, R] and terms [kOwn, R].
struct Smem {
  float *park, *key, *hard, *pts, *pen, *wk, *am;
  int *pc, *pk, *fill;
  float *ovx, *ovy, *own;
};

__host__ __device__ inline size_t shared_words(int R, int C, int Cs,
                                               int V) {
  return (size_t)R * ((size_t)C * (TS_FIELDS + 8) + Cs + 2 * V + kOwn);
}

__device__ __forceinline__ Smem carve(float* base, int R, int C, int Cs,
                                      int V) {
  const size_t cr = (size_t)C * R;
  Smem s;
  s.park = base;
  s.key = s.park + TS_FIELDS * cr;
  s.hard = s.key + cr;
  s.pts = s.hard + cr;
  s.pen = s.pts + cr;
  s.wk = s.pen + cr;
  s.am = s.wk + cr;
  s.pc = reinterpret_cast<int*>(s.am + cr);
  s.pk = s.pc + cr;
  s.fill = s.pk + cr;
  s.ovx = reinterpret_cast<float*>(s.fill + (size_t)Cs * R);
  s.ovy = s.ovx + (size_t)V * R;
  s.own = s.ovy + (size_t)V * R;
  return s;
}

// V is the compiled vertex width; the tables hold a.V <= V planes, and the
// planes past them are copies of v0 (the same values the padded planes
// held).
template <int V>
__global__ void __launch_bounds__(kThreads, kBlocks)
    tile_manifold_kernel(TileManifoldArgs a) {
  extern __shared__ float smem[];
  const int C = a.C, Cs = a.Cs, Nt = a.Nt, Vr = a.V;
  const int R = blockDim.x, L = blockDim.y;  // rows, slot lanes
  const int r = threadIdx.x, lane = threadIdx.y;
  const int t = blockIdx.y;
  const int i = blockIdx.x * R + r;
  const size_t row = (size_t)t * kT + i;
  const size_t splane = (size_t)Cs * kT;          // one solve-table field
  float* sol = a.sol + (size_t)t * TS_FIELDS * splane + i;
  const size_t cbase = (size_t)t * Cs * kT + i;   // [Nt, Cs, T] slot 0

  if (!(a.tile_live[t] > 0.f)) {
    // skipped tile (its whole window asleep): zero outputs, no compute
    for (int s = lane; s < Cs; s += L) {
      for (int f = 0; f < TS_FIELDS; ++f) sol[f * splane + (size_t)s * kT] = 0.f;
      a.pidx_c[cbase + (size_t)s * kT] = 0;
      a.src[cbase + (size_t)s * kT] = 0;
      if (a.keyc) a.keyc[cbase + (size_t)s * kT] = 0;
    }
    if (lane == 0) {
      a.nact[((size_t)t * 2) * kT + i] = 0;
      a.nact[((size_t)t * 2 + 1) * kT + i] = 0;
      a.wake[row] = 0.f; a.pen[row] = 0.f; a.npts[row] = 0.f;
    }
    return;
  }
  const Smem sh = carve(smem, R, C, Cs, V);
  const size_t cr = (size_t)C * R;  // one parked field

  // 1. the own row: pose, world vertices, speed bound
  for (int s = lane; s < Cs; s += L) sh.fill[s * R + r] = -1;
  if (lane == 0) {
    const float o_px = a.px[row], o_py = a.py[row], o_an = a.an[row];
    const float o_ca = cosf(o_an), o_sa = sinf(o_an);
    float o_ext = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int pv = v < Vr ? v : 0;
      const float x = a.vlx[((size_t)t * Vr + pv) * kT + i];
      const float y = a.vly[((size_t)t * Vr + pv) * kT + i];
      sh.ovx[v * R + r] = o_px + o_ca * x - o_sa * y;
      sh.ovy[v * R + r] = o_py + o_sa * x + o_ca * y;
      const float d = sqrtf(x * x + y * y);
      o_ext = v ? fmaxf(o_ext, d) : d;
    }
    o_ext = o_ext + a.rad[row];
    const float ovx = a.vx[row], ovy = a.vy[row], oom = a.om[row];
    sh.own[r] = o_px;
    sh.own[R + r] = o_py;
    sh.own[2 * R + r] = o_ca;
    sh.own[3 * R + r] = o_sa;
    sh.own[4 * R + r] = sqrtf(ovx * ovx + ovy * ovy) + fabsf(oom) * o_ext;
  }
  __syncthreads();

  // 2. each table slot's manifold, parked
  const float o_px = sh.own[r], o_py = sh.own[R + r];
  const float o_ca = sh.own[2 * R + r], o_sa = sh.own[3 * R + r];
  const float o_spd = sh.own[4 * R + r];
  for (int c = lane; c < C; c += L) {
    const int rc = c * R + r;
    const size_t g = ((size_t)t * C + c) * kT + i;
    const int pc = a.pidx[g];
    const float act = a.act[g];
    sh.pc[rc] = pc;
    if (Cs < C && act == 0.f) {
      // empty under compaction: every mask is 0, so no point, depth or
      // wake, never active (n_hard counts active slots only)
      sh.key[rc] = kBig;
      sh.am[rc] = 0.f;
      sh.hard[rc] = 0.f;
      sh.pts[rc] = 0.f;
      sh.pen[rc] = 0.f;
      sh.wk[rc] = 0.f;
      continue;
    }
    // partner: a window row or a large-set static
    const int pr = tile_candidate(t, Nt, pc);
    float p_px, p_py, p_an, pvx, pvy, pom, p_rad;
    int p_nv;
    const float *pvlx, *pvly;
    int vstride;
    if (pr >= 0) {
      p_px = a.px[pr]; p_py = a.py[pr]; p_an = a.an[pr];
      pvx = a.vx[pr]; pvy = a.vy[pr]; pom = a.om[pr];
      p_rad = a.rad[pr]; p_nv = a.nv[pr];
      pvlx = a.vlx + (size_t)(pr / kT) * Vr * kT + pr % kT;
      pvly = a.vly + (size_t)(pr / kT) * Vr * kT + pr % kT;
      vstride = kT;
    } else {
      const int l = -1 - pr;
      p_px = a.l_px[l]; p_py = a.l_py[l]; p_an = a.l_an[l];
      pvx = 0.f; pvy = 0.f; pom = 0.f;
      p_rad = a.l_rad[l]; p_nv = a.l_nv[l];
      pvlx = a.l_vlx + l;
      pvly = a.l_vly + l;
      vstride = TILE_L;
    }
    const float p_ca = cosf(p_an), p_sa = sinf(p_an);
    float vbx[V], vby[V], p_ext = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int pv = v < Vr ? v : 0;
      const float x = pvlx[pv * vstride], y = pvly[pv * vstride];
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
    float vax[V], vay[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      vax[v] = sh.ovx[v * R + r];
      vay[v] = sh.ovy[v * R + r];
    }
    Manifold m;
    manifold<V>(vax, vay, a.nv[row], a.rad[row], vbx, vby, p_nv, p_rad,
                margin_eff, m);
    const float pm0 = m.pmask[0] * act, pm1 = m.pmask[1] * act;
    const bool active = fmaxf(pm0, pm1) > 0.f;
    const float minsep = fminf(pm0 > 0.f ? m.sep[0] : kBig,
                               pm1 > 0.f ? m.sep[1] : kBig);
    // the partner's constants, read where the fields need them
    float p_fric, p_rst, p_sen, p_invm, p_invi, p_kin;
    if (pr >= 0) {
      p_fric = a.fric[pr]; p_rst = a.rst[pr]; p_sen = a.sen[pr];
      p_invm = a.invm[pr]; p_invi = a.invi[pr]; p_kin = a.kin[pr];
    } else {
      const int l = -1 - pr;
      p_fric = a.l_fric[l]; p_rst = a.l_rst[l]; p_sen = a.l_sen[l];
      p_invm = 0.f; p_invi = 0.f;
      p_kin = 0.f;  // the large set holds statics only (moves == 0)
    }
    const float solvable = act * (1.f - fmaxf(a.sen[row], p_sen));
    float* fp = sh.park + rc;  // field f at fp[f * cr]
    fp[TS_ACT * cr] = act;
    fp[TS_NAX * cr] = o_ca * m.nx + o_sa * m.ny;
    fp[TS_NAY * cr] = -o_sa * m.nx + o_ca * m.ny;
    fp[TS_FRIC * cr] = sqrtf(a.fric[row] * p_fric);
    fp[TS_REST * cr] = fmaxf(a.rst[row], p_rst);
    fp[TS_IMB * cr] = p_invm;
    fp[TS_IIB * cr] = p_invi;
    fp[TS_PDYN * cr] = p_invm > 0.f ? 1.f : 0.f;
    const float pm[2] = {pm0, pm1};
    float pen_c = 0.f;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float dxa = m.wax[q] - o_px, dya = m.way[q] - o_py;
      const float dxb = m.wbx[q] - p_px, dyb = m.wby[q] - p_py;
      fp[(TS_AAX0 + q) * cr] = o_ca * dxa + o_sa * dya;
      fp[(TS_AAY0 + q) * cr] = -o_sa * dxa + o_ca * dya;
      fp[(TS_BAX0 + q) * cr] = p_ca * dxb + p_sa * dyb;
      fp[(TS_BAY0 + q) * cr] = -p_sa * dxb + p_ca * dyb;
      fp[(TS_SM0 + q) * cr] = pm[q] * solvable;
      fp[(TS_PM0 + q) * cr] = pm[q];
      fp[(TS_SEP0 + q) * cr] = m.sep[q];
      pen_c = fmaxf(pen_c, fmaxf(-m.sep[q], 0.f) * pm[q]);
    }
    sh.key[rc] = active ? minsep : kBig;
    sh.am[rc] = active ? 1.f : 0.f;
    sh.hard[rc] = minsep < a.margin ? 1.f : 0.f;
    // undirected points: a window pair appears in both rows
    sh.pts[rc] = (pm0 + pm1) * (pc < TILE_WIN * kT ? 0.5f : 1.f);
    sh.pen[rc] = pen_c;
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
    sh.wk[rc] = w;
    if (a.keyc) {
      const int32_t oc = a.cid[row];
      const int32_t qc = pr >= 0 ? a.cid[pr] : a.lcid[-1 - pr];
      sh.pk[rc] = (int32_t)((uint32_t)min(oc, qc) * (uint32_t)a.n_colliders
                            + (uint32_t)max(oc, qc));
    }
  }
  __syncthreads();

  // 3. ranks (the solve slot each active table slot fills) and row sums
  if (Cs < C) {
    for (int c = lane; c < C; c += L) {
      if (!(sh.am[c * R + r] > 0.f)) continue;
      const float kc = sh.key[c * R + r];
      int rank = 0;
      for (int k = 0; k < C; ++k) {
        const float kk = sh.key[k * R + r];
        rank += (kk < kc) || (kk == kc && k < c);
      }
      if (rank < Cs) sh.fill[rank * R + r] = c;
    }
  }
  if (lane == 0) {
    int n_act = 0, n_hard = 0;
    float p_max = 0.f, w_max = 0.f, np = sh.pts[r];
    for (int k = 0; k < C; ++k) {
      const int rk = k * R + r;
      const bool on = sh.am[rk] > 0.f;
      n_act += on;
      n_hard += sh.hard[rk] > 0.f && on;
      p_max = fmaxf(p_max, sh.pen[rk]);
      w_max = fmaxf(w_max, sh.wk[rk]);
      if (k) np = np + sh.pts[rk];
    }
    a.nact[((size_t)t * 2) * kT + i] = n_act;
    a.nact[((size_t)t * 2 + 1) * kT + i] = n_hard;
    a.pen[row] = p_max;
    a.wake[row] = w_max;
    a.npts[row] = np;
  }
  __syncthreads();

  // 4. the solve slots, a (row, solve slot) item each: without compaction
  // solve slot s is table slot s; with it, the table slot ranked s, or
  // zeros past the row's active count
  for (int s = lane; s < Cs; s += L) {
    const size_t o = cbase + (size_t)s * kT;
    const int c = Cs < C ? sh.fill[s * R + r] : s;
    if (c >= 0) {
      const float* fp = sh.park + c * R + r;
      for (int f = 0; f < TS_FIELDS; ++f)
        sol[f * splane + (size_t)s * kT] = fp[f * cr];
      a.pidx_c[o] = sh.pc[c * R + r];
      a.src[o] = c;
      if (a.keyc) a.keyc[o] = sh.pk[c * R + r];
    } else {
      for (int f = 0; f < TS_FIELDS; ++f)
        sol[f * splane + (size_t)s * kT] = 0.f;
      a.pidx_c[o] = 0;
      a.src[o] = 0;
      if (a.keyc) a.keyc[o] = 0;
    }
  }
}

// the compiled vertex width of a V-plane table (0: none)
int kernel_width(int V) {
  return V < 1 ? 0 : V <= 4 ? 4 : V <= 6 ? 6 : V <= 8 ? 8 : 0;
}

// rows a block: 16 (16 slot lanes) from 16 table slots up, else 32 (8
// lanes); fewer (more lanes) where C's parked constants would not fit
int block_rows(int C, int Cs, int Vk) {
  int R = C >= 16 ? 16 : 32;
  while (R > 1 && shared_words(R, C, Cs, Vk) * sizeof(float) >
                      (size_t)F2_SHARED_LIMIT)
    R /= 2;
  return R;
}

size_t shared_bytes(int C, int Cs, int Vk) {
  return shared_words(block_rows(C, Cs, Vk), C, Cs, Vk) * sizeof(float);
}

const void* manifold_kernel(int Vk) {
  return Vk == 4   ? (const void*)tile_manifold_kernel<4>
         : Vk == 6 ? (const void*)tile_manifold_kernel<6>
                   : (const void*)tile_manifold_kernel<8>;
}

constexpr int kMaxDevices = 64;

// Lets instance Vk take `shmem` bytes of dynamic shared memory on the
// current device: set once a device and instance, and again only for a
// launch that needs more (the frame loop is host-bound).
cudaError_t allow_shared(int Vk, size_t shmem) {
  static size_t allowed[kMaxDevices][3];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  size_t* done = dev < kMaxDevices ? &allowed[dev][Vk / 2 - 2] : nullptr;
  if (done && shmem <= *done) return cudaSuccess;
  err = cudaFuncSetAttribute(manifold_kernel(Vk),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shmem);
  if (err == cudaSuccess && done) *done = shmem;
  return err;
}

}  // namespace

SF_EXPORT(sf_tile_manifold, TileManifoldArgs)

extern "C" int sf_tile_solve_fields() { return TS_FIELDS; }

// The compiled vertex width that takes V vertex planes (0: none).
extern "C" int sf_tile_manifold_width(int V) { return kernel_width(V); }

// Dynamic shared memory of one block at V vertex planes, C table and Cs
// solve slots (0 if no compiled width takes V).
extern "C" long long sf_tile_manifold_shared_bytes(int V, int C, int Cs) {
  const int Vk = kernel_width(V);
  return Vk ? (long long)shared_bytes(C, Cs, Vk) : 0;
}

// Resident blocks an SM there (0 on error).
extern "C" int sf_tile_manifold_blocks_per_sm(int V, int C, int Cs) {
  const int Vk = kernel_width(V);
  if (!Vk) return 0;
  const size_t shmem = shared_bytes(C, Cs, Vk);
  int blocks = 0;
  if (allow_shared(Vk, shmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, manifold_kernel(Vk), kThreads, shmem) != cudaSuccess)
    return 0;
  return blocks;
}

extern "C" int sf_tile_manifold(const TileManifoldArgs* a, void* stream) {
  const int Vk = kernel_width(a->V);
  if (a->C < 1 || a->Cs < 1 || a->Cs > a->C || !Vk)
    return (int)cudaErrorInvalidValue;
  if (a->Nt <= 0) return (int)cudaGetLastError();
  const int R = block_rows(a->C, a->Cs, Vk);
  const size_t shmem = shared_words(R, a->C, a->Cs, Vk) * sizeof(float);
  if (shmem > (size_t)F2_SHARED_LIMIT) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_shared(Vk, shmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(R, kThreads / R), grid(kT / R, a->Nt);
  const cudaStream_t st = (cudaStream_t)stream;
  if (Vk == 4)
    tile_manifold_kernel<4><<<grid, block, shmem, st>>>(*a);
  else if (Vk == 6)
    tile_manifold_kernel<6><<<grid, block, shmem, st>>>(*a);
  else
    tile_manifold_kernel<8><<<grid, block, shmem, st>>>(*a);
  return (int)cudaGetLastError();
}
