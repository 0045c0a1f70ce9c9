// Static pair-eligibility mask for the slot-table broadphase.
//
// Replaces starframe_tpu/pallas/slots.py `_elig_kernel` (launched by
// `build_elig_mask`). Output elig[w, j, i] (int8) says whether partner
// collider j may ever enter collider i's slot row: different bodies, each
// one's layer bit set in the other's mask, both active, the own row
// responds to impulses (or is a moving sensor), and the pair moves or holds
// a sensor.
//
// What bounds it on an H100: the store. At W = 4096, M = 256 the mask is
// 268 MB, written once per rollout (0.08 ms at 3.35 TB/s); the inputs are 7
// small [W, M] / [W, N] rows. Design: a 2-D grid, a block per (world, 256
// partner rows j). The block first stages its world's per-collider words in
// shared memory, one int4 a collider: body, layer bit, mask and a flag word
// (active; the row may respond, through the body's `responds`/`moves`
// gathered once; moves or is a sensor), and reduces them to one flag that
// says whether every pair of the world passes both layer tests. A thread
// then owns sixteen consecutive own colliders i, keeps their words in
// registers (their flags as two byte masks, one for each rule a partner
// may impose), and walks rows j, reading j's words as one 16-byte broadcast
// and writing the sixteen bytes as one 16-byte store. When the layer flag
// is set a byte costs one compare (the bodies differ). No division, no
// global gather and no shared load per byte. Rows that do not start
// 16-byte aligned store four bytes at a time (M % 4 == 0) or byte by byte.
// A block's threads take a row's groups at once, so M is at most 4096 (the
// frame kernels take 1024); past it the entry point refuses the call.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;  // partner rows j a block
constexpr int kOwn = 16;    // own colliders i a thread: one 16-byte store
constexpr int kMaxM = kThreads * kOwn;  // a group of sixteen a thread

// Bit s of x under XLA's (and PyTorch's) arithmetic-shift rule, where a
// shift by 32 or more (or a negative one) leaves only the sign: bit 31.
__device__ __forceinline__ uint32_t layer_bit(int s) {
  return 1u << ((s < 0 || s > 31) ? 31 : s);
}

// flag bits of a collider
constexpr int kActive = 1;  // active > 0
constexpr int kRowOk = 2;   // responds, or a moving sensor
constexpr int kMovesOrSensor = 4;

// Bytes b of word q of a thread's row j: 1 where the pair (j, own collider
// 4 q + b) passes the body test and, unless kLayersPass, both layer tests.
template <bool kLayersPass>
__device__ __forceinline__ uint32_t pair_bytes(const int* ci,
                                               const uint32_t* li,
                                               const uint32_t* mi, int q,
                                               int cbj, uint32_t lbj,
                                               uint32_t lmj) {
  uint32_t bytes = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int o = 4 * q + b;
    bool ok = ci[o] != cbj;
    if (!kLayersPass) ok = ok & ((mi[o] & lbj) != 0) & ((lmj & li[o]) != 0);
    bytes |= (uint32_t)ok << (8 * b);
  }
  return bytes;
}

// Rows j = j0 + r0, j0 + r0 + rstep, ... below j1 of own group g.
template <int kStore, bool kLayersPass>
__device__ __forceinline__ void write_rows(const int4* words, int8_t* out,
                                           int M, int g, int r0, int rstep,
                                           int j0, int j1) {
  // own colliders i = 16 g .. 16 g + 15: their words stay in registers
  int ci[kOwn];
  uint32_t li[kOwn], mi[kOwn];
  uint32_t ok_any[4] = {0, 0, 0, 0};  // partner j moves or is a sensor
  uint32_t ok_own[4] = {0, 0, 0, 0};  // it does neither: i must
#pragma unroll
  for (int o = 0; o < kOwn; ++o) {
    const int4 cw = words[kOwn * g + o];
    ci[o] = cw.x;
    li[o] = (uint32_t)cw.y;
    mi[o] = (uint32_t)cw.z;
    const int f = cw.w, any = kActive | kRowOk, own = any | kMovesOrSensor;
    ok_any[o >> 2] |= (uint32_t)((f & any) == any) << (8 * (o & 3));
    ok_own[o >> 2] |= (uint32_t)((f & own) == own) << (8 * (o & 3));
  }
  for (int j = j0 + r0; j < j1; j += rstep) {
    const int4 cw = words[j];  // a broadcast
    const int flj = cw.w;
    // both active, the own row may respond, and (unless partner j moves
    // or is a sensor) the own collider moves or is a sensor
    const bool act = (flj & kActive) != 0;
    const bool any = (flj & kMovesOrSensor) != 0;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = pair_bytes<kLayersPass>(ci, li, mi, q, cw.x, (uint32_t)cw.y,
                                     (uint32_t)cw.z) &
             (act ? (any ? ok_any[q] : ok_own[q]) : 0u);
    int8_t* row = out + (size_t)j * M + kOwn * g;
    if (kStore == 16) {
      *reinterpret_cast<uint4*>(row) = make_uint4(v[0], v[1], v[2], v[3]);
    } else if (kStore == 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (kOwn * g + 4 * q < M) reinterpret_cast<uint32_t*>(row)[q] = v[q];
    } else {
#pragma unroll
      for (int o = 0; o < kOwn; ++o)
        if (kOwn * g + o < M) row[o] = (int8_t)(v[o >> 2] >> (8 * (o & 3)));
    }
  }
}

template <int kStore>
__global__ void __launch_bounds__(kThreads) elig_kernel(EligArgs a) {
  // a collider's words: body, layer_bit(layer), mask, flags
  extern __shared__ __align__(16) int4 words[];
  __shared__ uint32_t layers_or[kThreads / 32], masks_and[kThreads / 32];
  const int M = a.M, N = a.N;
  const int M16 = (M + kOwn - 1) & ~(kOwn - 1);  // whole groups of sixteen
  const size_t w = blockIdx.x;
  const int tid = threadIdx.x;
  uint32_t lor = 0, mand = ~0u;  // over this thread's colliders
  for (int i = tid; i < M16; i += kThreads) {
    int4 cw = make_int4(-1, 0, 0, 0);
    if (i < M) {
      const size_t ri = w * M + i;
      const int c = a.cbody[ri];
      const bool sen = a.sensor[ri] > 0.f;
      const bool mov = a.moves[w * N + c] > 0.f;
      cw = make_int4(
          c, (int)layer_bit(a.layer[ri]), a.lmask[ri],
          (a.active[ri] > 0.f ? kActive : 0) |
              (a.responds[w * N + c] > 0.f || (sen && mov) ? kRowOk : 0) |
              (mov || sen ? kMovesOrSensor : 0));
      lor |= (uint32_t)cw.y;
      mand &= (uint32_t)cw.z;
    }
    words[i] = cw;
  }
  lor = __reduce_or_sync(0xffffffffu, lor);
  mand = __reduce_and_sync(0xffffffffu, mand);
  if ((tid & 31) == 0) {
    layers_or[tid >> 5] = lor;
    masks_and[tid >> 5] = mand;
  }
  __syncthreads();
  // every mask of the world holds every layer bit of the world: both layer
  // tests pass for every pair (the padding's bytes are never stored)
  lor = 0;
  mand = ~0u;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) {
    lor |= layers_or[k];
    mand &= masks_and[k];
  }
  const bool layers_pass = (mand & lor) == lor;

  // a row's groups of sixteen go to consecutive threads, rows side by side
  // (M <= kMaxM: at most one group a thread)
  const int groups = M16 / kOwn, rstep = kThreads / groups;
  const int g = tid % groups, r0 = tid / groups;
  if (r0 >= rstep) return;
  const int j0 = blockIdx.y * kRows, j1 = min(M, j0 + kRows);
  int8_t* out = a.elig + w * M * M;
  if (layers_pass)
    write_rows<kStore, true>(words, out, M, g, r0, rstep, j0, j1);
  else
    write_rows<kStore, false>(words, out, M, g, r0, rstep, j0, j1);
}

template <int kStore>
int launch(const EligArgs* a, cudaStream_t stream) {
  const dim3 grid(a->W, (a->M + kRows - 1) / kRows);
  const size_t shmem =
      (size_t)((a->M + kOwn - 1) & ~(kOwn - 1)) * sizeof(int4);
  cudaError_t err = cudaFuncSetAttribute(
      elig_kernel<kStore>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  elig_kernel<kStore><<<grid, kThreads, shmem, stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

SF_EXPORT(sf_elig, EligArgs)

extern "C" int sf_elig(const EligArgs* a, void* stream) {
  if (a->M > kMaxM) return (int)cudaErrorInvalidValue;
  if (a->W <= 0 || a->M <= 0) return (int)cudaGetLastError();
  const uintptr_t base = reinterpret_cast<uintptr_t>(a->elig);
  const cudaStream_t st = (cudaStream_t)stream;
  if (a->M % 16 == 0 && base % 16 == 0) return launch<16>(a, st);
  if (a->M % 4 == 0 && base % 4 == 0) return launch<4>(a, st);
  return launch<1>(a, st);
}

// An error code's text, for the wrappers' messages (hopper/_build.py).
extern "C" const char* sf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
