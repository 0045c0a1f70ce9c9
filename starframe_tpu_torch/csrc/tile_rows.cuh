// The per-row bodies of the tile engine's substep, shared by the
// per-substep pair (tile_substep.cu: K8 project, K9 apply), the
// whole-frame kernel (tile_frame.cu: K10) and the compound whole-frame
// kernel (tile_compound_frame.cu), so that all compute the same float32
// operations in the same order and stay bitwise equal.
//
// One layout, (row, slot) work items: `project_group`/`apply_group` give a
// block of 256 threads 32 rows of one tile, one thread a (row, slot) item,
// 8 slot items of a row at once. Each item computes its slot's
// contribution and parks it in shared memory; then one thread a row adds
// the parked contributions in slot order, skipping the slots whose solve
// mask is zero at both points, as the TPU kernel's slot loop does. Each
// item that solves a slot computes its row's own terms itself, with the
// same expressions, so no item waits for another before the sum. So the
// sums, and every output, are those of one thread walking the row's slots
// in order.
//
// `project_group`: integrate (derived: the state is not written), then
// XPBD contact projection of each row of the group over its solve slots
// against the partners' integrated poses; writes the own-row Jacobi sums,
// lam and the max-accumulated touched table. `apply_group`: the
// count-normalised, clipped corrections, velocity reconstruction, and the
// restitution/friction velocity pass against each partner's post-apply
// state derived from the correction windows; writes the row's new state. A
// tile whose `tile_live` is 0 zeroes its corrections and passes its state
// through. `apply_group<true>` is the compound rows' form (K9 with
// `compound`): it writes the velocity pass's raw sums to `accv` instead of
// normalising and damping, since a compound body's count is the sum over
// its rows (the caller's owner reduction, owner_reduce.cu, or the compound
// frame's owner phase); K10 never runs it.
//
// CCD (the `kCcd` forms, cfg.ccd): `ccd_group` is K7, a bullet row's TOI
// factor f in [0, 1] over its solve slots for this substep, in the same
// (row, slot) layout: each item takes its slot's factor and one thread a
// row their minimum, in slot order; a group without a bullet, and a
// skipped tile, write 1 without a slot's work. The `kCcd` forms of
// `project_group` and `apply_group` scale the own and each window
// partner's pose advance by their f (a large-set static's is 1), while the
// velocities keep full speed. f = 1 scales by an exact 1, so a world with
// no bullet takes the same values as the non-CCD forms.
#pragma once

#include "common.cuh"
#include "contact.cuh"

namespace {

constexpr int kT = TILE_T;

struct Partner {
  float px, py, an, vx, vy, om;
  int row;  // flat row, or -1 for a large-set static
};

__device__ __forceinline__ Partner partner(const float* px, const float* py,
                                           const float* an, const float* vx,
                                           const float* vy, const float* om,
                                           const float* l_px,
                                           const float* l_py,
                                           const float* l_an, int t, int Nt,
                                           int pc) {
  Partner p;
  const int r = tile_candidate(t, Nt, pc);
  if (r >= 0) {
    p.px = px[r]; p.py = py[r]; p.an = an[r];
    p.vx = vx[r]; p.vy = vy[r]; p.om = om[r];
    p.row = r;
  } else {
    const int l = -1 - r;
    p.px = l_px[l]; p.py = l_py[l]; p.an = l_an[l];
    p.vx = 0.f; p.vy = 0.f; p.om = 0.f;
    p.row = -1;
  }
  return p;
}

// applied (count-normalised, clipped) correction of a row, as its own tile
// applies it
__device__ __forceinline__ float applied(float d, float cnt,
                                         const TileApplyArgs& a) {
  const float scale = a.relaxation / fmaxf(cnt, 1.f);
  return fminf(fmaxf(d * scale, -a.max_dpos), a.max_dpos);
}

// ---- (row, slot) work items ---------------------------------------------

constexpr int kGroupRows = 32;  // rows a block: one a lane of each warp
constexpr int kSlotLanes = 8;   // slot items of a row at once: one a warp
constexpr int kItemThreads = kGroupRows * kSlotLanes;  // 256
constexpr int kRowGroups = kT / kGroupRows;  // row groups a tile
// resident blocks an SM K7, K8 and K9 are built for: at most 85 registers
// a thread (uncapped, K9's compound CCD form took 102 and fit two)
constexpr int kItemBlocks = 3;

// One round of slot contributions of a row group, [term][slot lane][row]:
// a warp's 32 lanes are 32 rows, so its stores and the summing warp's
// loads hit 32 banks.
struct GroupShared {
  float part[4][kSlotLanes][kGroupRows];
  int used[kSlotLanes][kGroupRows];
};

// Each item parks its contribution; then lane 0 (the row's own thread)
// adds the round's parked contributions to `acc` in slot order. The
// block's threads meet before and after.
__device__ __forceinline__ void sum_round(GroupShared& sh, int s0, int Cs,
                                          int r, int lane, int used,
                                          const float c[4], float acc[4]) {
  sh.used[lane][r] = used;
  for (int q = 0; q < 4; ++q) sh.part[q][lane][r] = c[q];
  __syncthreads();
  if (lane == 0) {
    for (int j = 0; j < kSlotLanes && s0 + j < Cs; ++j) {
      if (!sh.used[j][r]) continue;
      acc[0] += sh.part[0][j][r];
      acc[1] += sh.part[1][j][r];
      acc[2] += sh.part[2][j][r];
      acc[3] += sh.part[3][j][r];
    }
  }
  __syncthreads();
}

// K7 over row group g of tile t (rows g * 32 .. g * 32 + 31), a (row,
// slot) item a thread; every thread of the block calls it. The TOI factor
// of a row for this substep (tiles.py `_ccd_math`): own and partner poses
// are integrated one substep without clamping (large-set partners do not
// move); for each point of a solved slot, the pair's closing along the
// frame-start normal is c0 - c1 with the anchors at the substep's start
// and end poses, and where it would carry the pair past ccd_slop of
// penetration the factor that lands it there is taken. The row's f is the
// min over points and slots; 1 on a row that is not a bullet and in a
// skipped tile. Each item takes its slot's min with 1 and parks it; one
// thread a row takes the parked factors' min with 1 in slot order. The
// factors are non-negative and not NaN, and fminf returns one of its
// arguments, so f is bitwise that of one thread walking the row's slots.
__device__ __forceinline__ void ccd_group(const TileCcdArgs& a, int t, int g,
                                          GroupShared& sh) {
  const int r = threadIdx.x % kGroupRows, lane = threadIdx.x / kGroupRows;
  const int i = g * kGroupRows + r;
  const size_t row = (size_t)t * kT + i;
  const bool bullet = a.blt[row] > 0.f;
  // the same for the whole block: a skipped tile, or no bullet in the group
  if (!(a.tile_live[t] > 0.f) || !__syncthreads_or(bullet)) {
    if (lane == 0) a.f[row] = 1.f;
    return;
  }
  const int Cs = a.Cs;
  const size_t splane = (size_t)Cs * kT;
  const float* sol = a.sol + (size_t)t * TS_FIELDS * splane + i;
  const size_t sbase = (size_t)t * Cs * kT + i;
  const float h = a.h, gx = a.gravity[0], gy = a.gravity[1];
  float f_row = 1.f;  // lane 0's
  // at least one round, so that the block meets even with no slots
  for (int s0 = 0; s0 == 0 || s0 < Cs; s0 += kSlotLanes) {
    const int s = s0 + lane;
    float f_acc = 1.f;
    const float* f = sol + (size_t)s * kT;
    const float sm0 = bullet && s < Cs ? f[TS_SM0 * splane] : 0.f;
    const float sm1 = bullet && s < Cs ? f[TS_SM1 * splane] : 0.f;
    if (sm0 > 0.f || sm1 > 0.f) {
      const float sm[2] = {sm0, sm1};
      const float o_px = a.px[row], o_py = a.py[row], o_an = a.an[row];
      const float dyn = a.dynb[row];
      // the unclamped integrated own pose
      const float opx_t = o_px + (a.vx[row] + gx * h * dyn) * h;
      const float opy_t = o_py + (a.vy[row] + gy * h * dyn) * h;
      const float oa_t = o_an + a.om[row] * h;
      const float oca0 = cosf(o_an), osa0 = sinf(o_an);
      const float oca1 = cosf(oa_t), osa1 = sinf(oa_t);
      const Partner p = partner(a.px, a.py, a.an, a.vx, a.vy, a.om, a.l_px,
                                a.l_py, a.l_an, t, a.Nt,
                                a.pidx_c[sbase + (size_t)s * kT]);
      const float p_dyn = f[TS_PDYN * splane];
      const float ppx_t = p.px + (p.vx + gx * h * p_dyn) * h;
      const float ppy_t = p.py + (p.vy + gy * h * p_dyn) * h;
      const float pa_t = p.an + p.om * h;
      const float pca0 = cosf(p.an), psa0 = sinf(p.an);
      const float pca1 = cosf(pa_t), psa1 = sinf(pa_t);
      const float n_ax = f[TS_NAX * splane], n_ay = f[TS_NAY * splane];
      // the frame-start normal, at the substep's start pose
      const float nx0 = oca0 * n_ax - osa0 * n_ay;
      const float ny0 = osa0 * n_ax + oca0 * n_ay;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (!(sm[q] > 0.f)) continue;
        const float a_ax = f[(TS_AAX0 + q) * splane];
        const float a_ay = f[(TS_AAY0 + q) * splane];
        const float b_ax = f[(TS_BAX0 + q) * splane];
        const float b_ay = f[(TS_BAY0 + q) * splane];
        const float wax0 = o_px + (oca0 * a_ax - osa0 * a_ay);
        const float way0 = o_py + (osa0 * a_ax + oca0 * a_ay);
        const float wbx0 = p.px + (pca0 * b_ax - psa0 * b_ay);
        const float wby0 = p.py + (psa0 * b_ax + pca0 * b_ay);
        const float wax1 = opx_t + (oca1 * a_ax - osa1 * a_ay);
        const float way1 = opy_t + (osa1 * a_ax + oca1 * a_ay);
        const float wbx1 = ppx_t + (pca1 * b_ax - psa1 * b_ay);
        const float wby1 = ppy_t + (psa1 * b_ax + pca1 * b_ay);
        const float c0 = (wbx0 - wax0) * nx0 + (wby0 - way0) * ny0;
        const float c1 = (wbx1 - wax1) * nx0 + (wby1 - way1) * ny0;
        const float advance = c0 - c1;
        const float allowed = fmaxf(c0, 0.f) + a.ccd_slop;
        if (advance > allowed)
          f_acc = fminf(f_acc, allowed / fmaxf(advance, 1e-10f));
      }
    }
    sh.part[0][lane][r] = f_acc;
    __syncthreads();
    if (lane == 0)
      for (int j = 0; j < kSlotLanes && s0 + j < Cs; ++j)
        f_row = fminf(f_row, sh.part[0][j][r]);
    __syncthreads();
  }
  if (lane == 0) a.f[row] = f_row;
}

// The own-row terms of the project phase: each item that solves a slot
// computes them itself, so no item waits for another.
struct OwnProject {
  float px, py, tpx, tpy, ca0, sa0, ca, sa, ima, iia;
};

template <bool kCcd>
__device__ __forceinline__ OwnProject own_project(const TileProjectArgs& a,
                                                  size_t row, float h,
                                                  float gx, float gy) {
  OwnProject o;
  o.px = a.px[row];
  o.py = a.py[row];
  const float o_an = a.an[row], o_om = a.om[row];
  const float dyn = a.dynb[row];
  // integrated own state (v_tilde + pose), derived algebraically
  const float ovx_t = a.vx[row] + gx * h * dyn;
  const float ovy_t = a.vy[row] + gy * h * dyn;
  float oa_t;
  if constexpr (kCcd) {  // the pose advance TOI-clamped, velocities not
    const float o_f = a.f[row];
    o.tpx = o.px + ovx_t * h * o_f;
    o.tpy = o.py + ovy_t * h * o_f;
    oa_t = o_an + o_om * h * o_f;
  } else {
    o.tpx = o.px + ovx_t * h;
    o.tpy = o.py + ovy_t * h;
    oa_t = o_an + o_om * h;
  }
  o.ca0 = cosf(o_an);
  o.sa0 = sinf(o_an);
  o.ca = cosf(oa_t);
  o.sa = sinf(oa_t);
  o.ima = a.invm[row];
  o.iia = a.invi[row];
  return o;
}

// The project phase over row group g of tile t (rows g * 32 .. g * 32 +
// 31), a (row, slot) item a thread; every thread of the block calls it.
template <bool kCcd = false>
__device__ __forceinline__ void project_group(const TileProjectArgs& a, int t,
                                              int g, GroupShared& sh) {
  const int r = threadIdx.x % kGroupRows, lane = threadIdx.x / kGroupRows;
  const int i = g * kGroupRows + r;
  const int Cs = a.Cs;
  const size_t row = (size_t)t * kT + i;
  const size_t splane = (size_t)Cs * kT;
  const float* sol = a.sol + (size_t)t * TS_FIELDS * splane + i;
  const size_t sbase = (size_t)t * Cs * kT + i;  // [Nt, Cs, T] slot 0
  if (!(a.tile_live[t] > 0.f)) {  // the same for the whole block
    // skipped tile: zero corrections, touched passes through
    if (lane == 0) {
      a.dxx[row] = 0.f; a.dxy[row] = 0.f; a.dth[row] = 0.f; a.cnt[row] = 0.f;
    }
    for (int s = lane; s < Cs; s += kSlotLanes) {
      a.lam[((size_t)t * 2 * Cs + s) * kT + i] = 0.f;
      a.lam[((size_t)t * 2 * Cs + Cs + s) * kT + i] = 0.f;
      a.touched[sbase + (size_t)s * kT] = a.touched_in[sbase + (size_t)s * kT];
    }
    return;
  }
  const float h = a.h, gx = a.gravity[0], gy = a.gravity[1];
  OwnProject o;
  bool have_own = false;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // lane 0's
  // at least one round, so that the block meets even with no slots
  for (int s0 = 0; s0 == 0 || s0 < Cs; s0 += kSlotLanes) {
    const int s = s0 + lane;
    int used = 0;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    if (s < Cs) {
      const float* f = sol + (size_t)s * kT;
      const float sm[2] = {f[TS_SM0 * splane], f[TS_SM1 * splane]};
      float* lam = a.lam + ((size_t)t * 2 * Cs + s) * kT + i;
      const float tin = a.touched_in[sbase + (size_t)s * kT];
      if (sm[0] == 0.f && sm[1] == 0.f) {
        lam[0] = 0.f;
        lam[(size_t)Cs * kT] = 0.f;
        a.touched[sbase + (size_t)s * kT] = tin;
      } else {
        if (!have_own) {
          o = own_project<kCcd>(a, row, h, gx, gy);
          have_own = true;
        }
        const Partner p = partner(a.px, a.py, a.an, a.vx, a.vy, a.om, a.l_px,
                                  a.l_py, a.l_an, t, a.Nt,
                                  a.pidx_c[sbase + (size_t)s * kT]);
        const float p_dyn = f[TS_PDYN * splane];
        const float pvx_t = p.vx + gx * h * p_dyn;
        const float pvy_t = p.vy + gy * h * p_dyn;
        float ppx_t, ppy_t, pa_t;
        if constexpr (kCcd) {
          const float p_f = p.row >= 0 ? a.f[p.row] : 1.f;
          ppx_t = p.px + pvx_t * h * p_f;
          ppy_t = p.py + pvy_t * h * p_f;
          pa_t = p.an + p.om * h * p_f;
        } else {
          ppx_t = p.px + pvx_t * h;
          ppy_t = p.py + pvy_t * h;
          pa_t = p.an + p.om * h;
        }
        const float pca0 = cosf(p.an), psa0 = sinf(p.an);
        const float pca = cosf(pa_t), psa = sinf(pa_t);
        const float imb = f[TS_IMB * splane], iib = f[TS_IIB * splane];
        const float fric = f[TS_FRIC * splane];
        const float n_ax = f[TS_NAX * splane], n_ay = f[TS_NAY * splane];
        const float nx = o.ca * n_ax - o.sa * n_ay;
        const float ny = o.sa * n_ax + o.ca * n_ay;
        float cax = 0.f, cay = 0.f, dang = 0.f, nact = 0.f, tk = 0.f;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float a_ax = f[(TS_AAX0 + q) * splane];
          const float a_ay = f[(TS_AAY0 + q) * splane];
          const float b_ax = f[(TS_BAX0 + q) * splane];
          const float b_ay = f[(TS_BAY0 + q) * splane];
          const float rax = o.ca * a_ax - o.sa * a_ay;
          const float ray = o.sa * a_ax + o.ca * a_ay;
          const float rbx = pca * b_ax - psa * b_ay;
          const float rby = psa * b_ax + pca * b_ay;
          // static-friction reference: the anchors at the substep's start
          const float ref[4] = {o.px + (o.ca0 * a_ax - o.sa0 * a_ay),
                                o.py + (o.sa0 * a_ax + o.ca0 * a_ay),
                                p.px + (pca0 * b_ax - psa0 * b_ay),
                                p.py + (psa0 * b_ax + pca0 * b_ay)};
          float ax, ay, da, dlam;
          bool active;
          project_point(rax, ray, rbx, rby, o.tpx + rax, o.tpy + ray,
                        ppx_t + rbx, ppy_t + rby, nx, ny, [&] { return sm[q]; },
                        [&](int k) { return ref[k]; }, o.ima, o.iia, imb, iib,
                        fric, a.alpha_t, ax, ay, da, dlam, active);
          cax = q ? cax + ax : ax;
          cay = q ? cay + ay : ay;
          dang = q ? dang + da : da;
          nact += active ? 1.f : 0.f;
          lam[(size_t)q * Cs * kT] = dlam;
          tk = fmaxf(tk, (dlam > 0.f ? 1.f : 0.f) * f[(TS_PM0 + q) * splane]);
        }
        c[0] = cax * o.ima;
        c[1] = cay * o.ima;
        c[2] = dang;
        c[3] = nact;
        used = 1;
        a.touched[sbase + (size_t)s * kT] = fmaxf(tin, tk);
      }
    }
    sum_round(sh, s0, Cs, r, lane, used, c, acc);
  }
  if (lane == 0) {
    a.dxx[row] = acc[0];
    a.dxy[row] = acc[1];
    a.dth[row] = acc[2];
    a.cnt[row] = acc[3];
  }
}

// The own-row terms of the apply phase: the new pose, the reconstructed
// velocities before the velocity pass and what the pass reads of the row.
struct OwnApply {
  float npx, npy, nan_, nvx, nvy, nom, tvx, tvy, om, ca, sa, ima, iia;
};

template <bool kCcd>
__device__ __forceinline__ OwnApply own_apply(const TileApplyArgs& a,
                                              size_t row, float h, float gx,
                                              float gy) {
  OwnApply o;
  const float dyn = a.dynb[row], kin = a.kin[row];
  const float cnt = a.cnt[row];
  const float o_ddx = applied(a.dxx[row], cnt, a);
  const float o_ddy = applied(a.dxy[row], cnt, a);
  const float o_dda = applied(a.dth[row], cnt, a);
  o.om = a.om[row];
  o.tvx = a.vx[row] + gx * h * dyn;
  o.tvy = a.vy[row] + gy * h * dyn;
  if constexpr (kCcd) {  // the pose advance TOI-clamped, velocities not
    const float o_f = a.f[row];
    o.npx = a.px[row] + o.tvx * h * o_f + o_ddx;
    o.npy = a.py[row] + o.tvy * h * o_f + o_ddy;
    o.nan_ = a.an[row] + o.om * h * o_f + o_dda;
  } else {
    o.npx = a.px[row] + o.tvx * h + o_ddx;
    o.npy = a.py[row] + o.tvy * h + o_ddy;
    o.nan_ = a.an[row] + o.om * h + o_dda;
  }
  // velocity reconstruction (kinematic rows keep their velocity)
  const float nk = 1.f - kin;
  o.nvx = kin * o.tvx + nk * (o.tvx + o_ddx / h);
  o.nvy = kin * o.tvy + nk * (o.tvy + o_ddy / h);
  o.nom = kin * o.om + nk * (o.om + o_dda / h);
  o.ca = cosf(o.nan_);
  o.sa = sinf(o.nan_);
  o.ima = a.invm[row];
  o.iia = a.invi[row];
  return o;
}

// The apply phase over row group g of tile t, a (row, slot) item a
// thread; every thread of the block calls it.
template <bool kCompound = false, bool kCcd = false>
__device__ __forceinline__ void apply_group(const TileApplyArgs& a, int t,
                                            int g, GroupShared& sh) {
  const int r = threadIdx.x % kGroupRows, lane = threadIdx.x / kGroupRows;
  const int i = g * kGroupRows + r;
  const int Cs = a.Cs;
  const size_t row = (size_t)t * kT + i;
  const size_t plane = (size_t)a.Nt * kT;  // one accv field
  if (!(a.tile_live[t] > 0.f)) {  // the same for the whole block
    // skipped tile: its bodies are frozen, the state passes through
    if (lane == 0) {
      a.o_px[row] = a.px[row]; a.o_py[row] = a.py[row];
      a.o_an[row] = a.an[row]; a.o_vx[row] = a.vx[row];
      a.o_vy[row] = a.vy[row]; a.o_om[row] = a.om[row];
      if (kCompound)
        for (int q = 0; q < 4; ++q) a.accv[q * plane + row] = 0.f;
    }
    return;
  }
  const size_t splane = (size_t)Cs * kT;
  const float* sol = a.sol + (size_t)t * TS_FIELDS * splane + i;
  const size_t sbase = (size_t)t * Cs * kT + i;
  const float h = a.h, gx = a.gravity[0], gy = a.gravity[1];
  OwnApply o;
  bool have_own = lane == 0;  // lane 0 writes the row's new state
  if (have_own) o = own_apply<kCcd>(a, row, h, gx, gy);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // lane 0's
  // at least one round, so that the block meets even with no slots
  for (int s0 = 0; s0 == 0 || s0 < Cs; s0 += kSlotLanes) {
    const int s = s0 + lane;
    int used = 0;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const float* f = sol + (size_t)s * kT;
    const float sm0 = s < Cs ? f[TS_SM0 * splane] : 0.f;
    const float sm1 = s < Cs ? f[TS_SM1 * splane] : 0.f;
    if (s < Cs && !(sm0 == 0.f && sm1 == 0.f)) {
      const float sm[2] = {sm0, sm1};
      if (!have_own) {
        o = own_apply<kCcd>(a, row, h, gx, gy);
        have_own = true;
      }
      const Partner p = partner(a.px, a.py, a.an, a.vx, a.vy, a.om, a.l_px,
                                a.l_py, a.l_an, t, a.Nt,
                                a.pidx_c[sbase + (size_t)s * kT]);
      const float p_dyn = f[TS_PDYN * splane];
      const float pvx_t = p.vx + gx * h * p_dyn;
      const float pvy_t = p.vy + gy * h * p_dyn;
      float p_ddx = 0.f, p_ddy = 0.f, p_dda = 0.f;
      if (p.row >= 0) {
        const float pcnt = a.cnt[p.row];
        p_ddx = applied(a.dxx[p.row], pcnt, a);
        p_ddy = applied(a.dxy[p.row], pcnt, a);
        p_dda = applied(a.dth[p.row], pcnt, a);
      }
      // the partner's post-apply angle and velocity, as its own row makes
      // them (the velocity pass reads no partner position)
      float pan;
      if constexpr (kCcd) {
        const float p_f = p.row >= 0 ? a.f[p.row] : 1.f;
        pan = p.an + p.om * h * p_f + p_dda;
      } else {
        pan = p.an + p.om * h + p_dda;
      }
      const float pnvx = pvx_t + p_ddx / h;
      const float pnvy = pvy_t + p_ddy / h;
      const float pnom = p.om + p_dda / h;
      const float pca = cosf(pan), psa = sinf(pan);
      const float imb = f[TS_IMB * splane], iib = f[TS_IIB * splane];
      const float fric = f[TS_FRIC * splane], rest = f[TS_REST * splane];
      const float n_ax = f[TS_NAX * splane], n_ay = f[TS_NAY * splane];
      const float nx = o.ca * n_ax - o.sa * n_ay;
      const float ny = o.sa * n_ax + o.ca * n_ay;
      float cbx = 0.f, cby = 0.f, dng = 0.f, nact = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float a_ax = f[(TS_AAX0 + q) * splane];
        const float a_ay = f[(TS_AAY0 + q) * splane];
        const float b_ax = f[(TS_BAX0 + q) * splane];
        const float b_ay = f[(TS_BAY0 + q) * splane];
        const float rax = o.ca * a_ax - o.sa * a_ay;
        const float ray = o.sa * a_ax + o.ca * a_ay;
        const float rbx = pca * b_ax - psa * b_ay;
        const float rby = psa * b_ax + pca * b_ay;
        const float lam = a.lam[((size_t)t * 2 * Cs + q * Cs + s) * kT + i];
        float impx, impy, dd;
        bool active;
        velocity_point(rax, ray, rbx, rby, nx, ny, o.nvx, o.nvy, o.nom, pnvx,
                       pnvy, pnom, o.tvx, o.tvy, o.om, pvx_t, pvy_t, p.om,
                       [&] { return lam; }, [&] { return sm[q]; }, o.ima,
                       o.iia, imb, iib, rest, fric, h, a.rest_threshold, impx,
                       impy, dd, active);
        cbx = q ? cbx + impx : impx;
        cby = q ? cby + impy : impy;
        dng = q ? dng + dd : dd;
        nact += active ? 1.f : 0.f;
      }
      c[0] = -cbx * o.ima;
      c[1] = -cby * o.ima;
      c[2] = -dng;
      c[3] = nact;
      used = 1;
    }
    sum_round(sh, s0, Cs, r, lane, used, c, acc);
  }
  if (lane != 0) return;
  float nvx = o.nvx, nvy = o.nvy, nom = o.nom;
  if (kCompound) {
    for (int q = 0; q < 4; ++q) a.accv[q * plane + row] = acc[q];
  } else {
    const float cntv = fmaxf(acc[3], 1.f);
    nvx = nvx + acc[0] / cntv;
    nvy = nvy + acc[1] / cntv;
    nom = nom + acc[2] / cntv;
    if (a.use_lin_damp) {
      nvx = nvx * a.lin_sdamp;
      nvy = nvy * a.lin_sdamp;
    }
    if (a.use_ang_damp) nom = nom * a.ang_sdamp;
  }
  a.o_px[row] = o.npx; a.o_py[row] = o.npy; a.o_an[row] = o.nan_;
  a.o_vx[row] = nvx; a.o_vy[row] = nvy; a.o_om[row] = nom;
}

}  // namespace
