// Slot-table broadphase: for every collider row, the first C eligible
// partners whose boxes overlap, ranked touching < margin-close < swept.
//
// Replaces starframe_tpu/pallas/slots.py `_slot_kernel` (launched by
// `build_slot_tables`). Per world it computes each collider's touch, close
// and swept AABBs (optionally the partner-aware two-phase inflation) and
// emits partner/slot_act [W, C, M], count/count_touch/count_close [W, M]
// and the sweep budget [W, M].
//
// What bounds it on an H100: the M x M pair tests (65,536 per world,
// ~20 compare-and-selects each) and one read of the 268 MB eligibility
// mask per phase at W = 4096, M = 256. The TPU built a dense f32 [M, M]
// mask and ranked it with a lower-triangular matmul; that mask would be
// 256 KB, more than a block's shared memory, and the matmul is a TPU
// answer. Design: one CTA per world, one thread per own collider i. The
// world's boxes live in shared memory (13 floats per collider), so the
// j-loop reads them as warp-wide broadcasts while the elig byte loads are
// coalesced across i. Each thread scans j in ascending order and keeps the
// first C candidates of each tier in a small local array, then merges the
// tiers touch -> close -> swept into its C slots: exactly the TPU's `crank`
// order (tier first, ascending partner index within a tier). Partner-aware
// mode takes two scans with a __syncthreads() between them. Empty slots get
// partner 0 and act 0, which is what the TPU's one-hot sums yield.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 32;

struct Boxes {
  float *tlx, *thx, *tly, *thy;  // touch
  float *clx, *chx, *cly, *chy;  // close
  float *slx, *shx, *sly, *shy;  // swept
  float *sx, *sy, *ns;           // per-axis sweeps, partner-aware sweep
};

__device__ __forceinline__ bool overlap(const float* lx, const float* hx,
                                        const float* ly, const float* hy,
                                        int j, int i) {
  return (lx[j] <= hx[i]) && (lx[i] <= hx[j]) && (ly[j] <= hy[i]) &&
         (ly[i] <= hy[j]);
}

__global__ void __launch_bounds__(kThreads) slot_kernel(SlotArgs a) {
  extern __shared__ float smem[];
  const int M = a.M, N = a.N, V = a.V, C = a.C;
  const long long w = blockIdx.x;
  Boxes b;
  float* p = smem;
  float** fields[] = {&b.tlx, &b.thx, &b.tly, &b.thy, &b.clx, &b.chx,
                      &b.cly, &b.chy, &b.slx, &b.shx, &b.sly, &b.shy,
                      &b.sx,  &b.sy,  &b.ns};
  for (float** f : fields) {
    *f = p;
    p += M;
  }
  const int8_t* elig = a.elig + w * M * M;

  // ---- boxes per collider --------------------------------------------
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const int ob = a.cbody[w * M + i];
    const long long bo = w * N + ob;
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
    b.tlx[i] = lox - tp; b.thx[i] = hix + tp;
    b.tly[i] = loy - tp; b.thy[i] = hiy + tp;
    const float clx = lox - cp, chx = hix + cp, cly = loy - cp, chy = hiy + cp;
    b.clx[i] = clx; b.chx[i] = chx; b.cly[i] = cly; b.chy[i] = chy;
    const float sx = fabsf(a.velx[bo]) * a.dt;
    const float sy = fabsf(a.vely[bo]) * a.dt;
    b.sx[i] = sx;
    b.sy[i] = sy;
    b.slx[i] = clx - sx; b.shx[i] = chx + sx;
    b.sly[i] = cly - sy; b.shy[i] = chy + sy;
  }
  __syncthreads();

  if (a.partner_aware) {
    // phase 1: who can reach collider i within the window at current
    // speeds; inflate i's (symmetric) sweep to the max over them
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      float ps = 0.f;
      for (int j = 0; j < M; ++j) {
        if (elig[(long long)j * M + i] &&
            overlap(b.slx, b.shx, b.sly, b.shy, j, i))
          ps = fmaxf(ps, b.sx[j]);
      }
      b.ns[i] = fmaxf(b.sx[i], ps);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      const float ns = b.ns[i];
      b.slx[i] = b.clx[i] - ns; b.shx[i] = b.chx[i] + ns;
      b.sly[i] = b.cly[i] - ns; b.shy[i] = b.chy[i] + ns;
    }
    __syncthreads();
  }

  // ---- rank and select ------------------------------------------------
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    int lt[kMaxC], lm[kMaxC], lf[kMaxC];
    int nt = 0, nm = 0, nf = 0, ncl = 0;
    for (int j = 0; j < M; ++j) {
      if (!elig[(long long)j * M + i]) continue;
      if (!overlap(b.slx, b.shx, b.sly, b.shy, j, i)) continue;
      const bool touch = overlap(b.tlx, b.thx, b.tly, b.thy, j, i);
      const bool close = overlap(b.clx, b.chx, b.cly, b.chy, j, i);
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
    const long long row = w * M + i;
    int k = 0;
    for (int t = 0; t < nt && k < C; ++t, ++k) {
      a.partner[(w * C + k) * M + i] = lt[t];
      a.slot_act[(w * C + k) * M + i] = 1.f;
    }
    for (int t = 0; t < nm && k < C; ++t, ++k) {
      a.partner[(w * C + k) * M + i] = lm[t];
      a.slot_act[(w * C + k) * M + i] = 1.f;
    }
    for (int t = 0; t < nf && k < C; ++t, ++k) {
      a.partner[(w * C + k) * M + i] = lf[t];
      a.slot_act[(w * C + k) * M + i] = 1.f;
    }
    for (; k < C; ++k) {
      a.partner[(w * C + k) * M + i] = 0;
      a.slot_act[(w * C + k) * M + i] = 0.f;
    }
    a.count[row] = nt + nm + nf;
    a.count_touch[row] = nt;
    a.count_close[row] = ncl;
    a.budget[row] = a.partner_aware ? b.ns[i] : fminf(b.sx[i], b.sy[i]);
  }
}

}  // namespace

SF_EXPORT(sf_slots, SlotArgs)

extern "C" int sf_slots(const SlotArgs* a, void* stream) {
  if (a->C > kMaxC) return (int)cudaErrorInvalidValue;
  const size_t shmem = 15 * (size_t)a->M * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      slot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  if (a->W > 0)
    slot_kernel<<<a->W, kThreads, shmem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
