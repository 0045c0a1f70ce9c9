// Per-body joint slot tables: body n's first JC active joints, in
// joint-index order, and which end of each joint n is.
//
// Replaces starframe_tpu/pallas/slots.py `_joint_slot_kernel` (launched by
// `build_joint_slots`). Outputs jslot [W, JC, N] (joint row), jside
// [W, JC, N] (1 where n is endpoint A), jact [W, JC, N] and count [W, N],
// the true number of n's joints (the caller's joint_overflow counter is
// the sum of count - JC where positive).
//
// What bounds it on an H100: nothing much. It runs once per rollout (the
// joint topology is constant inside one) over J <= 1024 joints and N <= 1024
// bodies per world: ~J compares per body. The TPU ranked a dense [J, N]
// incidence mask with a lower-triangular matmul and selected with one-hot
// sums. Design: one CTA per world, the world's endpoints and active flags
// in shared memory (read as warp-wide broadcasts), one thread per body
// scanning j in ascending order and keeping the first JC hits: the same
// rank, exactly. Stores are coalesced across n. Empty slots get 0, 0, 0,
// which is what the TPU's one-hot sums yield.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) joint_slot_kernel(JointSlotArgs a) {
  extern __shared__ int32_t jsm[];
  const int N = a.N, J = a.J, JC = a.JC;
  const long long w = blockIdx.x;
  int32_t* ba = jsm;
  int32_t* bb = jsm + J;
  float* act = reinterpret_cast<float*>(jsm + 2 * J);
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    ba[j] = a.jba[w * J + j];
    bb[j] = a.jbb[w * J + j];
    act[j] = a.jactive[w * J + j];
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    int k = 0;
    for (int j = 0; j < J; ++j) {
      if (!(act[j] > 0.f)) continue;
      const bool is_a = ba[j] == n;
      if (!is_a && bb[j] != n) continue;
      if (k < JC) {
        const long long o = (w * JC + k) * N + n;
        a.jslot[o] = j;
        a.jside[o] = is_a ? 1.f : 0.f;
        a.jact[o] = 1.f;
      }
      ++k;
    }
    for (int c = k; c < JC; ++c) {
      const long long o = (w * JC + c) * N + n;
      a.jslot[o] = 0;
      a.jside[o] = 0.f;
      a.jact[o] = 0.f;
    }
    a.count[w * N + n] = k;
  }
}

}  // namespace

SF_EXPORT(sf_joint_slots, JointSlotArgs)

extern "C" int sf_joint_slots(const JointSlotArgs* a, void* stream) {
  const size_t shmem = 3 * (size_t)a->J * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      joint_slot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  if (a->W > 0)
    joint_slot_kernel<<<a->W, kThreads, shmem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
