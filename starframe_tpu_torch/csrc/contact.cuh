// Contact math shared by the frame kernels (frame2.cuh, tile_manifold.cu,
// tile_substep.cu): the manifold of two rounded convex polygons
// (kernels.manifold_batch, per thread and scalar), one manifold point's
// XPBD position projection (kernels.solve_contacts_b) and its
// restitution/friction velocity impulse (kernels.velocity_contacts_b).
// Every expression keeps the reference's operation order: the kernels are
// compiled with -fmad=false and no fast math, so they round as the plain
// PyTorch twins do, and a contact threshold (c < 0, lam > 0) decides the
// same way on both.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-10f;
constexpr float kTouchSlop = 1e-3f;
constexpr float kInf = __builtin_huge_valf();

template <int V>
__device__ __forceinline__ float sel(const float (&a)[V], int k) {
  float r = a[0];
#pragma unroll
  for (int j = 1; j < V; ++j) r = (j == k) ? a[j] : r;
  return r;
}

// the far end of edge k: vertex k + 1, or v0 at the wrap (k = nv - 1 or
// V - 1); selected where it is needed, so no array of the far ends is kept
// (~32 fewer registers live at V = 8)
template <int V>
__device__ __forceinline__ float sel_next(const float (&a)[V], int nv,
                                          int k) {
  float r = a[0];
#pragma unroll
  for (int j = 0; j + 1 < V; ++j) r = (j == k) ? a[j + 1] : r;
  return k == nv - 1 ? a[0] : r;
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

template <int V>
__device__ __forceinline__ void edge_data(const float (&vx)[V],
                                          const float (&vy)[V], int nv,
                                          float (&nx)[V], float (&ny)[V],
                                          bool (&valid)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const bool wrap = k == nv - 1;
    const int kn = (k + 1 == V) ? 0 : k + 1;
    const float e1x = wrap ? vx[0] : vx[kn];
    const float e1y = wrap ? vy[0] : vy[kn];
    const float dx = e1x - vx[k], dy = e1y - vy[k];
    const float len = sqrtf(dx * dx + dy * dy);
    valid[k] = (k < nv) && (nv >= 2) && (len > 1e-9f);
    const float inv = 1.f / fmaxf(len, kEps);
    nx[k] = dy * inv;  // outward normal of a CCW edge
    ny[k] = -dx * inv;
  }
}

// max separation over own edge normals vs the other shape's verts, and the
// first edge attaining it
template <int V>
__device__ __forceinline__ void sat(const float (&e0x)[V],
                                    const float (&e0y)[V],
                                    const float (&nx)[V], const float (&ny)[V],
                                    const bool (&valid)[V],
                                    const float (&ox)[V], const float (&oy)[V],
                                    float& best, int& kbest) {
  float sep[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float mn = nx[k] * ox[0] + ny[k] * oy[0];
#pragma unroll
    for (int j = 1; j < V; ++j) mn = fminf(mn, nx[k] * ox[j] + ny[k] * oy[j]);
    const float s = mn - (nx[k] * e0x[k] + ny[k] * e0y[k]);
    sep[k] = valid[k] ? s : -kInf;
  }
  best = sep[0];
#pragma unroll
  for (int k = 1; k < V; ++k) best = fmaxf(best, sep[k]);
  kbest = 0;
#pragma unroll
  for (int k = V - 1; k >= 0; --k)
    if (sep[k] == best) kbest = k;
}

__device__ __forceinline__ void closest_seg_seg(
    float p1x, float p1y, float q1x, float q1y, float p2x, float p2y,
    float q2x, float q2y, float& c1x, float& c1y, float& c2x, float& c2y) {
  const float d1x = q1x - p1x, d1y = q1y - p1y;
  const float d2x = q2x - p2x, d2y = q2y - p2y;
  const float rx = p1x - p2x, ry = p1y - p2y;
  const float a = d1x * d1x + d1y * d1y;
  const float e = d2x * d2x + d2y * d2y;
  const float f = d2x * rx + d2y * ry;
  const float c = d1x * rx + d1y * ry;
  const float b = d1x * d2x + d1y * d2y;
  const float denom = a * e - b * b;
  const bool a_deg = a <= kEps, e_deg = e <= kEps;
  const float a_safe = a_deg ? 1.f : a, e_safe = e_deg ? 1.f : e;
  float s_gen = denom > kEps ? clamp01((b * f - c * e) / denom) : 0.f;
  float t_gen = (b * s_gen + f) / e_safe;
  const float t_cl = clamp01(t_gen);
  const float s_re = clamp01((b * t_cl - c) / a_safe);
  if (t_gen < 0.f || t_gen > 1.f) s_gen = s_re;
  t_gen = t_cl;
  const float s = (a_deg && e_deg) ? 0.f
                  : a_deg          ? 0.f
                  : e_deg          ? clamp01(-c / a_safe)
                                   : s_gen;
  const float t = (a_deg && e_deg) ? 0.f
                  : a_deg          ? clamp01(f / e_safe)
                  : e_deg          ? 0.f
                                   : t_gen;
  c1x = p1x + d1x * s;
  c1y = p1y + d1y * s;
  c2x = p2x + d2x * t;
  c2y = p2y + d2y * t;
}

struct Manifold {
  float nx, ny;
  float wax[2], way[2], wbx[2], wby[2], sep[2], pmask[2];
};

// kernels.manifold_batch for one pair of rounded convex polygons
template <int V>
__device__ void manifold(const float (&vax)[V], const float (&vay)[V],
                         int na, float ra, const float (&vbx)[V],
                         const float (&vby)[V], int nb, float rb,
                         float margin, Manifold& m) {
  float nax[V], nay[V], nbx[V], nby[V];
  bool eva[V], evb[V];
  edge_data<V>(vax, vay, na, nax, nay, eva);
  edge_data<V>(vbx, vby, nb, nbx, nby, evb);
  float sep_a, sep_b;
  int ka, kb;
  sat<V>(vax, vay, nax, nay, eva, vbx, vby, sep_a, ka);
  sat<V>(vbx, vby, nbx, nby, evb, vax, vay, sep_b, kb);

  const bool a_has = na >= 2, b_has = nb >= 2;
  const bool both_points = !(a_has || b_has);
  const bool flip = sep_b > sep_a + 1e-5f;
  const float s_core = fmaxf(sep_a, sep_b);

  const float r0x = flip ? sel(vbx, kb) : sel(vax, ka);
  const float r0y = flip ? sel(vby, kb) : sel(vay, ka);
  const float r1x = flip ? sel_next(vbx, nb, kb) : sel_next(vax, na, ka);
  const float r1y = flip ? sel_next(vby, nb, kb) : sel_next(vay, na, ka);
  const float nrx = flip ? sel(nbx, kb) : sel(nax, ka);
  const float nry = flip ? sel(nby, kb) : sel(nay, ka);
  const float r_ref = flip ? rb : ra;
  const float r_inc = flip ? ra : rb;

  // incident edge: most anti-parallel normal on the other shape
  float inc_a[V], inc_b[V];
  float mina = kInf, minb = kInf;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    inc_a[k] = eva[k] ? nax[k] * nrx + nay[k] * nry : kInf;
    inc_b[k] = evb[k] ? nbx[k] * nrx + nby[k] * nry : kInf;
    mina = fminf(mina, inc_a[k]);
    minb = fminf(minb, inc_b[k]);
  }
  int ia = 0, ib = 0;
#pragma unroll
  for (int k = V - 1; k >= 0; --k) {
    if (inc_a[k] == mina) ia = k;
    if (inc_b[k] == minb) ib = k;
  }
  const bool i_has = (flip && a_has) || (!flip && b_has);
  const float i0x = flip ? (a_has ? sel(vax, ia) : vax[0])
                         : (b_has ? sel(vbx, ib) : vbx[0]);
  const float i0y = flip ? (a_has ? sel(vay, ia) : vay[0])
                         : (b_has ? sel(vby, ib) : vby[0]);
  const float i1x = flip ? (a_has ? sel_next(vax, na, ia) : vax[0])
                         : (b_has ? sel_next(vbx, nb, ib) : vbx[0]);
  const float i1y = flip ? (a_has ? sel_next(vay, na, ia) : vay[0])
                         : (b_has ? sel_next(vby, nb, ib) : vby[0]);
  const float inc_dot = flip ? mina : minb;

  // ---- clip path ----
  const float tdx = r1x - r0x, tdy = r1y - r0y;
  const float t_len = sqrtf(tdx * tdx + tdy * tdy);
  const float inv_t = 1.f / fmaxf(t_len, kEps);
  const float thx = tdx * inv_t, thy = tdy * inv_t;
  const float lo = thx * r0x + thy * r0y;
  const float hi = thx * r1x + thy * r1y;
  const float s0 = thx * i0x + thy * i0y;
  const float s1 = thx * i1x + thy * i1y;
  const float ds = s1 - s0;
  const bool ds_ok = fabsf(ds) > 1e-6f;
  const float inv_ds = ds_ok ? 1.f / ds : 0.f;
  const float lo_ = fminf(lo, hi), hi_ = fmaxf(lo, hi);
  const float cs0 = fminf(fmaxf(s0, lo_), hi_);
  const float cs1 = fminf(fmaxf(s1, lo_), hi_);
  const float f0 = (cs0 - s0) * inv_ds;
  const float f1 = (cs1 - s0) * inv_ds;
  float q0x = i0x + (i1x - i0x) * f0, q0y = i0y + (i1y - i0y) * f0;
  float q1x = i0x + (i1x - i0x) * f1, q1y = i0y + (i1y - i0y) * f1;
  // perpendicular-incident degenerate clip: take the deepest endpoint
  const bool deep0 = (nrx * i0x + nry * i0y) <= (nrx * i1x + nry * i1y);
  const float dpx = deep0 ? i0x : i1x, dpy = deep0 ? i0y : i1y;
  if (!ds_ok) {
    q0x = dpx; q0y = dpy; q1x = dpx; q1y = dpy;
  }
  float csep[2], cwrx[2], cwry[2], cwix[2], cwiy[2];
  const float qx[2] = {q0x, q1x}, qy[2] = {q0y, q1y};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float plane = nrx * (qx[p] - r0x) + nry * (qy[p] - r0y);
    csep[p] = plane - r_ref - r_inc;
    cwrx[p] = qx[p] - nrx * plane + nrx * r_ref;
    cwry[p] = qy[p] - nry * plane + nry * r_ref;
    cwix[p] = qx[p] - nrx * r_inc;
    cwiy[p] = qy[p] - nry * r_inc;
  }
  const float dqx = q1x - q0x, dqy = q1y - q0y;
  const bool clip_distinct = sqrtf(dqx * dqx + dqy * dqy) > 1e-6f;

  // ---- closest path ----
  float c1x, c1y, c2x, c2y;
  closest_seg_seg(r0x, r0y, r1x, r1y, i0x, i0y, i1x, i1y, c1x, c1y, c2x, c2y);
  if (both_points) {
    c1x = flip ? vbx[0] : vax[0];
    c1y = flip ? vby[0] : vay[0];
    c2x = flip ? vax[0] : vbx[0];
    c2y = flip ? vay[0] : vby[0];
  }
  const float dvx = c2x - c1x, dvy = c2y - c1y;
  const float d_len = sqrtf(dvx * dvx + dvy * dvy);
  const float inv_d = 1.f / fmaxf(d_len, kEps);
  const float ncx = d_len > 1e-9f ? dvx * inv_d : (both_points ? 0.f : nrx);
  const float ncy = d_len > 1e-9f ? dvy * inv_d : (both_points ? 1.f : nry);
  const float psep = d_len - r_ref - r_inc;
  const float pwrx = c1x + ncx * r_ref, pwry = c1y + ncy * r_ref;
  const float pwix = c2x - ncx * r_inc, pwiy = c2y - ncy * r_inc;

  // ---- choose path ----
  const bool parallel = i_has && (inc_dot < -0.98f);
  const bool clip_has_extent = fabsf(cs1 - cs0) > 1e-6f;
  const bool both_thin = (na <= 2) && (nb <= 2);
  const bool deep_clip = (s_core <= 0.f) && !both_thin;
  const bool use_clip =
      !both_points && (deep_clip || (parallel && clip_has_extent));

  const float fl = flip ? -1.f : 1.f;
  m.nx = (use_clip ? nrx : ncx) * fl;
  m.ny = (use_clip ? nry : ncy) * fl;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float wrx = use_clip ? cwrx[p] : pwrx;
    const float wry = use_clip ? cwry[p] : pwry;
    const float wix = use_clip ? cwix[p] : pwix;
    const float wiy = use_clip ? cwiy[p] : pwiy;
    m.sep[p] = use_clip ? csep[p] : psep;
    m.wax[p] = flip ? wix : wrx;
    m.way[p] = flip ? wiy : wry;
    m.wbx[p] = flip ? wrx : wix;
    m.wby[p] = flip ? wry : wiy;
  }
  m.pmask[0] = (m.sep[0] < margin) ? 1.f : 0.f;
  m.pmask[1] = (use_clip && clip_distinct && (m.sep[1] < margin)) ? 1.f : 0.f;
}

// One manifold point's XPBD contact projection: the own body's position
// correction (ax, ay) and angle correction da, the normal multiplier dlam
// and whether the point is active (penetrating and solvable). r* are the
// anchor offsets from each body's centre, w* the anchors' world positions
// at the pose being solved, w*0 the static-friction reference (the same
// anchors at the substep's start).
//
// `sm()` reads the point's solve mask and `ref(k)` the reference's wax0,
// way0, wbx0, wby0 (k = 0..3), each where the computation first needs it, so
// a caller that keeps them in memory loads them in the reference's order.
template <class SolveMask, class Ref>
__device__ __forceinline__ void project_point(
    float rax, float ray, float rbx, float rby, float wax, float way,
    float wbx, float wby, float nx, float ny, SolveMask sm, Ref ref,
    float ima, float iia, float imb, float iib, float fric, float alpha_t,
    float& ax, float& ay, float& da, float& dlam, bool& active) {
  const float cc = (wbx - wax) * nx + (wby - way) * ny;
  active = (cc < 0.f) && (sm() > 0.f);
  const float cr_a = rax * ny - ray * nx;
  const float cr_b = rbx * ny - rby * nx;
  const float w_a = ima + iia * cr_a * cr_a;
  const float w_b = imb + iib * cr_b * cr_b;
  const float den = w_a + w_b + alpha_t;
  dlam = (active && den > kEps) ? -cc / fmaxf(den, kEps) : 0.f;
  const float p_x = dlam * nx, p_y = dlam * ny;
  // static friction at position level
  const float dpx = (wax - ref(0)) - (wbx - ref(2));
  const float dpy = (way - ref(1)) - (wby - ref(3));
  const float dpn = dpx * nx + dpy * ny;
  const float tx = dpx - dpn * nx, ty = dpy - dpn * ny;
  const float ct = sqrtf(tx * tx + ty * ty);
  const float inv_ct = 1.f / fmaxf(ct, kEps);
  const float thx = tx * inv_ct, thy = ty * inv_ct;
  const float cr_at = rax * thy - ray * thx;
  const float cr_bt = rbx * thy - rby * thx;
  const float w_at = ima + iia * cr_at * cr_at;
  const float w_bt = imb + iib * cr_bt * cr_bt;
  const float dent = w_at + w_bt;
  const float dlam_t = dent > kEps ? -ct / fmaxf(dent, kEps) : 0.f;
  const bool stick = active && (fabsf(dlam_t) < fric * dlam);
  const float pt_x = stick ? dlam_t * thx : 0.f;
  const float pt_y = stick ? dlam_t * thy : 0.f;
  ax = -p_x + pt_x;
  ay = -p_y + pt_y;
  da = iia * (-(rax * p_y - ray * p_x) + (rax * pt_y - ray * pt_x));
}

// One manifold point's restitution + dynamic friction impulse imp (applied
// +imp to the partner, -imp to the own body), the own body's angular
// response dd = iia * (r_a x imp), and whether the point is active. v* are
// the post-solve velocities, v0* those at the substep's start (the
// approach speed restitution answers). `lam_of()` reads the point's
// normal multiplier and `sm()` its solve mask where the computation first
// needs them (see project_point).
template <class Lam, class SolveMask>
__device__ __forceinline__ void velocity_point(
    float rax, float ray, float rbx, float rby, float nx, float ny,
    float vax, float vay, float oa, float vbx, float vby, float ob,
    float v0ax, float v0ay, float o0a, float v0bx, float v0by, float o0b,
    Lam lam_of, SolveMask sm, float ima, float iia, float imb, float iib,
    float rest, float fric, float h, float rest_threshold, float& impx,
    float& impy, float& dd, bool& active) {
  const float uax = vax - oa * ray, uay = vay + oa * rax;
  const float ubx = vbx - ob * rby, uby = vby + ob * rbx;
  const float relx = ubx - uax, rely = uby - uay;
  const float vn = relx * nx + rely * ny;
  const float utx = relx - vn * nx, uty = rely - vn * ny;
  const float vt = sqrtf(utx * utx + uty * uty);
  const float ua0x = v0ax - o0a * ray, ua0y = v0ay + o0a * rax;
  const float ub0x = v0bx - o0b * rby, ub0y = v0by + o0b * rbx;
  const float vn0 = (ub0x - ua0x) * nx + (ub0y - ua0y) * ny;
  const float lam = lam_of();
  active = (lam > 0.f) && (sm() > 0.f);
  const float cr_a = rax * ny - ray * nx;
  const float cr_b = rbx * ny - rby * nx;
  const float w_n = ima + iia * cr_a * cr_a + imb + iib * cr_b * cr_b;
  const float e = (vn0 < -rest_threshold) ? rest : 0.f;
  const float dv_n = active ? -vn + fmaxf(-e * vn0, 0.f) : 0.f;
  const float lam_v = w_n > kEps ? dv_n / fmaxf(w_n, kEps) : 0.f;
  const float pnx = lam_v * nx, pny = lam_v * ny;
  const float inv_vt = 1.f / fmaxf(vt, kEps);
  const float thx = utx * inv_vt, thy = uty * inv_vt;
  const float cr_at = rax * thy - ray * thx;
  const float cr_bt = rbx * thy - rby * thx;
  const float w_t = ima + iia * cr_at * cr_at + imb + iib * cr_bt * cr_bt;
  float lam_f = fminf(w_t > kEps ? vt / fmaxf(w_t, kEps) : 0.f,
                      fric * lam / h);
  lam_f = active ? lam_f : 0.f;
  impx = pnx - lam_f * thx;
  impy = pny - lam_f * thy;
  dd = iia * (rax * impy - ray * impx);
}

}  // namespace
