// The owner reductions' row bodies (owner_reduce.cu), shared by its
// per-substep kernels and the compound whole-frame kernel
// (tile_compound_frame.cu), so that both add the same terms in the same
// order and stay bitwise equal. See owner_reduce.cu for what they compute.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace {

// x's owner sum at row i: x[i], then the rows o = 1 .. kc-1 away, the one
// before first (torch.roll(x, o)[i] = x[i - o], then roll(x, -o))
__device__ __forceinline__ float owner_sum_row(const float* x,
                                               const int32_t* ob, int i,
                                               int n, int kc) {
  const int own = ob[i];
  float acc = x[i];
  for (int o = 1; o < kc; ++o) {
    const int step = o % n;
    const int lo = i - step < 0 ? i - step + n : i - step;
    const int hi = i + step >= n ? i + step - n : i + step;
    acc = acc + (ob[lo] == own ? x[lo] : 0.f);
    acc = acc + (ob[hi] == own ? x[hi] : 0.f);
  }
  return acc;
}

// x's owner minimum at row i, in owner_sum_row's order, +inf for a row of
// another owner
__device__ __forceinline__ float owner_min_row(const float* x,
                                               const int32_t* ob, int i,
                                               int n, int kc) {
  const int own = ob[i];
  float acc = x[i];
  for (int o = 1; o < kc; ++o) {
    const int step = o % n;
    const int lo = i - step < 0 ? i - step + n : i - step;
    const int hi = i + step >= n ? i + step - n : i + step;
    acc = fminf(acc, ob[lo] == own ? x[lo] : CUDART_INF_F);
    acc = fminf(acc, ob[hi] == own ? x[hi] : CUDART_INF_F);
  }
  return acc;
}

// the velocity pass of row i: accv's owner sums, normalised by the body's
// count, added to the row's velocities, then damping. Reads vx, vy, om at
// row i only, so `o_vx` may alias `vx` (the compound frame updates in
// place).
__device__ __forceinline__ void owner_velocity_row(const OwnerVelocityArgs& a,
                                                   int i) {
  const size_t plane = (size_t)a.n;
  const float ax = owner_sum_row(a.accv, a.ob, i, a.n, a.kc);
  const float ay = owner_sum_row(a.accv + plane, a.ob, i, a.n, a.kc);
  const float aw = owner_sum_row(a.accv + 2 * plane, a.ob, i, a.n, a.kc);
  const float cnt = owner_sum_row(a.accv + 3 * plane, a.ob, i, a.n, a.kc);
  const float cntv = fmaxf(cnt, 1.f);
  float nvx = a.vx[i] + ax / cntv;
  float nvy = a.vy[i] + ay / cntv;
  float nom = a.om[i] + aw / cntv;
  if (a.use_lin_damp) {
    nvx = nvx * a.lin_sdamp;
    nvy = nvy * a.lin_sdamp;
  }
  if (a.use_ang_damp) nom = nom * a.ang_sdamp;
  a.o_vx[i] = nvx;
  a.o_vy[i] = nvy;
  a.o_om[i] = nom;
}

}  // namespace
