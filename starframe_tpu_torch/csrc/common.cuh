// Argument structs and helpers shared by the kernels of this directory.
//
// Every entry point is `extern "C" int sf_<name>(const <Name>Args*, void*
// stream)`: it launches on the given stream and returns cudaGetLastError().
// `sf_<name>_args_size()` returns sizeof the struct so the Python side
// (hopper/_build.py, which mirrors each struct as a ctypes.Structure) can
// refuse a library whose layout differs from its own.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct EligArgs {
  const int32_t* cbody;     // [W, M]
  const int32_t* layer;     // [W, M]
  const int32_t* lmask;     // [W, M]
  const float* active;      // [W, M]
  const float* sensor;      // [W, M]
  const float* responds;    // [W, N]
  const float* moves;       // [W, N]
  int8_t* elig;             // [W, M(j), M(i)]
  int W, N, M;
};

struct SlotArgs {
  const float* posx;        // [W, N]
  const float* posy;
  const float* ang;
  const float* velx;        // per-body sweep speed, x axis
  const float* vely;
  const int32_t* cbody;     // [W, M]
  const float* vlx;         // [W, V, M] body-local core vertices
  const float* vly;
  const float* radius;      // [W, M]
  const int8_t* elig;       // [W, M(j), M(i)]
  int32_t* partner;         // [W, C, M]
  float* slot_act;          // [W, C, M]
  int32_t* count;           // [W, M]
  int32_t* count_touch;
  int32_t* count_close;
  float* budget;            // [W, M]
  int W, N, M, V, C;
  int partner_aware;
  float dt;                 // sweep window (seconds)
  float tpad;               // 0.1 * contact margin (touch boxes)
  float cpad;               // 0.5 * contact margin (close boxes)
};

struct JointSlotArgs {
  const int32_t* jba;       // [W, J] joint endpoint bodies
  const int32_t* jbb;
  const float* jactive;     // [W, J] 0/1
  int32_t* jslot;           // [W, JC, N] joint row per body slot
  float* jside;             // [W, JC, N] 1 where the body is endpoint A
  float* jact;              // [W, JC, N]
  int32_t* count;           // [W, N] joints per body (may exceed JC)
  int W, N, J, JC;
};

struct Frame2Args {
  const float* posx;        // [W, N] body state
  const float* posy;
  const float* ang;
  const float* velx;
  const float* vely;
  const float* angvel;
  const float* invm;
  const float* invi;
  const float* dyn;
  const float* kin;
  const int32_t* cbody;     // [W, M]
  const float* vlx;         // [W, V, M]
  const float* vly;
  const int32_t* nverts;    // [W, M]
  const float* radius;
  const float* fric;
  const float* rest;
  const float* sensor;
  const int32_t* partner;   // [W, C, M]
  const float* slot_act;    // [W, C, M]
  const float* gravity;     // [W, 2]
  const int32_t* owner_start;  // [N + 1] collider->body CSR (world 0's, or
  const int32_t* owner_idx;    // [M]  [W, N + 1] / [W, M] per world), ascending
  // slot records of rows i >= R (frame2.cu `place`): [W] tables of Csol
  // slots x (M - R) rows; null when every row's fits in shared memory
  uint8_t* gtab;
  float* o_posx;            // [W, N] outputs
  float* o_posy;
  float* o_ang;
  float* o_velx;
  float* o_vely;
  float* o_angvel;
  float* o_touched;         // [W, C, M]
  int W, N, M, V, C;
  int substeps, iterations;
  float h, dt, margin, alpha_t, relaxation, max_dpos, rest_threshold;
  float lin_sdamp, ang_sdamp;  // 1 / (1 + h * damping)
  int use_lin_damp, use_ang_damp;
  // joints: null pointers and J = 0 for a contact-only frame
  const int32_t* jtype;     // [W, J] joint parameters
  const int32_t* jba;
  const int32_t* jbb;
  const float* jaax;        // body-local anchors
  const float* jaay;
  const float* jabx;
  const float* jaby;
  const float* jrest;
  const float* jlo;
  const float* jhi;
  const float* jcomp;
  const float* jdamp;
  const float* jms;         // motor speed
  const float* jmm;         // motor torque budget (+inf as 3.4e38)
  const int32_t* jcolor;
  const int32_t* jslot;     // [W, JC, N] joint slots (joint_slots.cu)
  const float* jside;
  const float* jact;
  int J, JC;
  int joint_colored;        // 1: coloured Gauss-Seidel, 0: Jacobi
  int n_colors;
  float max_dpos_joint;     // clip of a coloured pass (the raw max_dpos)
  float hh;                 // h * h, rounded once (joint compliance scale)
  // CCD (the kCcd instantiation): null pointers and ccd = 0 without it
  const float* bullet;      // [W, N] 1 on a bullet body
  // with Cs too: the slots compaction drops, [W] tables of C - Cs slots x
  // M rows, which only the TOI reads; null otherwise
  uint8_t* side;
  int ccd;
  float ccd_slop;
  int owner_per_world;      // 1: owner_start/idx hold one CSR per world
  // per-frame solve-slot compaction: Cs = 0 for none, else the solve width
  int Cs;
  int32_t* o_partner;       // [W, C, M] the partner table in rank order
  float* o_nact;            // [W, 2, M] imminent / pmask-active slot counts
  // [W] scratch of frame2.cu `scratch_bytes`: with joints the joint list,
  // then the substep-start pose [4, N] (x, y, cos, sin), then the live set,
  // for what of them does not fit in shared memory beside the world's
  // state; null when all fit
  uint8_t* gscratch;
  // [1] the live (row, slot) items of every block's frame, added once a
  // block (the engagement counter); may be null
  unsigned long long* live_items;
  // [1] the same for the joint list's items (body, joint slot) with joints;
  // may be null
  unsigned long long* live_joint_items;
};

// A slot's record in the frame kernel's slot table: the float fields
// below, each a [Csol, rows] plane so that consecutive threads (rows i)
// read consecutive words, then the partner collider (int16) and a mask
// byte (F2_PM0 .. F2_TOUCHED) per slot. Everything else a slot uses is
// recomputed from the pose and the colliders in shared memory. The terms
// hold what the slot adds to its row's correction sum in a pass, computed
// slot-parallel and summed by the row in slot order.
enum Frame2Field {
  F2_NAX, F2_NAY,                       // body-local normal (own frame)
  F2_AAX0, F2_AAX1, F2_AAY0, F2_AAY1,   // body-local anchors on own body
  F2_BAX0, F2_BAX1, F2_BAY0, F2_BAY1,   // body-local anchors on partner
  F2_LAM0, F2_LAM1,                     // accumulated normal lambda
  F2_T0, F2_T1, F2_T2, F2_T3,           // the slot's term of a pass's row sum
  F2_FIELDS
};
enum Frame2Mask {
  F2_PM0 = 1, F2_PM1 = 2,               // point masks (manifold x slot_act)
  F2_SM0 = 4, F2_SM1 = 8,               // solve masks (x 1 - sensor)
  F2_TOUCHED = 16                       // the slot's running `touched`
};
#define F2_SLOT_BYTES (4 * F2_FIELDS + 3)
// shared memory one H100 block may use (hopper/frame2.py SHARED_LIMIT)
#define F2_SHARED_LIMIT 232448

// The tile engine (tile_tables.cu, tile_manifold.cu, tile_substep.cu).
// Rows are colliders sorted along the sort axis, cut into Nt tiles of
// TILE_T rows: per-row arrays [Nt, T] (flat row t * T + i), vertices
// [Nt, V, T]. Tile t's candidates are the 3T rows of its clamped window
// (first tile max(min(t - 1, Nt - 3), 0)) followed by the L large-set
// statics ([L], vertices [V, L]); a slot's partner index is that candidate
// index.
#define TILE_T 256
#define TILE_WIN 3
#define TILE_L 128

struct TileTablesArgs {
  const float* px;          // [Nt, T] state
  const float* py;
  const float* an;
  const float* vx;
  const float* vy;
  const float* vlx;         // [Nt, V, T]
  const float* vly;
  const float* rad;         // [Nt, T] consts
  const float* act;
  const float* mov;
  const int32_t* lay;
  const int32_t* msk;
  const int32_t* obody;
  const float* responds;
  const float* sen;
  const float* l_px;        // [L] large set
  const float* l_py;
  const float* l_an;
  const float* l_vlx;       // [V, L]
  const float* l_vly;
  const float* l_rad;
  const float* l_act;
  const int32_t* l_lay;
  const int32_t* l_msk;
  const float* edge_lo;     // [Nt] window coverage along the sort axis
  const float* edge_hi;
  const float* gravity;     // [2]
  int32_t* pidx;            // [Nt, C, T]
  float* act_o;             // [Nt, C, T]
  int32_t* count;           // [Nt, T]
  int32_t* count_touch;
  int32_t* count_close;
  int32_t* winover;
  float* sweep;             // [Nt, T]
  int Nt, V, C, sort_axis, sweep_frames;
  float dt, kdt;            // frame, sweep_frames * dt
  float tpad, cpad;         // 0.1 and 0.5 x the contact margin
  float sweep_slack, sweep_floor, sweep_cap;
};

// The frame's solve tables [Nt, TS_FIELDS, Cs, T]: one plane per constant
// (hopper/tiles.py SOL_KEYS).
enum TileSolveField {
  TS_ACT, TS_NAX, TS_NAY, TS_FRIC, TS_REST, TS_IMB, TS_IIB, TS_PDYN,
  TS_AAX0, TS_AAX1, TS_AAY0, TS_AAY1, TS_BAX0, TS_BAX1, TS_BAY0, TS_BAY1,
  TS_SM0, TS_SM1, TS_PM0, TS_PM1, TS_SEP0, TS_SEP1,
  TS_FIELDS
};

struct TileManifoldArgs {
  const float* px;          // [Nt, T] state
  const float* py;
  const float* an;
  const float* vx;
  const float* vy;
  const float* om;
  const float* vlx;         // [Nt, V, T]
  const float* vly;
  const float* rad;         // [Nt, T] consts
  const int32_t* nv;
  const float* fric;
  const float* rst;
  const float* sen;
  const float* invm;
  const float* invi;
  const float* l_px;        // [L] large set
  const float* l_py;
  const float* l_an;
  const float* l_vlx;       // [V, L]
  const float* l_vly;
  const float* l_rad;
  const int32_t* l_nv;
  const float* l_fric;
  const float* l_rst;
  const float* l_sen;
  const int32_t* pidx;      // [Nt, C, T] slot tables
  const float* act;
  const float* tile_live;   // [Nt]
  float* sol;               // [Nt, TS_FIELDS, Cs, T]
  int32_t* pidx_c;          // [Nt, Cs, T]
  int32_t* src;
  int32_t* nact;            // [Nt, 2, T]
  float* wake;              // [Nt, T]
  float* pen;
  float* npts;
  // contact-event keys: null pointers for a frame without events
  const int32_t* cid;       // [Nt, T] canonical collider id of each row
  const int32_t* lcid;      // [L] canonical collider id of each large slot
  int32_t* keyc;            // [Nt, Cs, T] min * n_colliders + max per slot
  const float* kin;         // [Nt, T] 1 on a kinematic row (the wake rule)
  int Nt, V, C, Cs;
  float margin, dt, sleep_v2;  // sleep_v2: squared wake speed
  int use_wake;
  int n_colliders;
  float kin_v2;             // squared speed of a kinematic partner that wakes
};

struct TileProjectArgs {
  const float* px;          // [Nt, T] state at the substep's start
  const float* py;
  const float* an;
  const float* vx;
  const float* vy;
  const float* om;
  const float* invm;        // [Nt, T] consts
  const float* invi;
  const float* dynb;
  const float* l_px;        // [L] large-set pose
  const float* l_py;
  const float* l_an;
  const int32_t* pidx_c;    // [Nt, Cs, T]
  const float* sol;         // [Nt, TS_FIELDS, Cs, T]
  const float* gravity;     // [2]
  const float* touched_in;  // [Nt, Cs, T]
  const float* tile_live;   // [Nt]
  float* dxx;               // [Nt, T] own-row Jacobi sums
  float* dxy;
  float* dth;
  float* cnt;
  float* lam;               // [Nt, 2, Cs, T]
  float* touched;           // [Nt, Cs, T]
  const float* f;           // [Nt, T] TOI factors (the kCcd form), or null
  int Nt, Cs;
  float h, alpha_t;
};

struct TileApplyArgs {
  const float* px;          // [Nt, T] state at the substep's start
  const float* py;
  const float* an;
  const float* vx;
  const float* vy;
  const float* om;
  const float* dxx;         // [Nt, T] the project phase's sums
  const float* dxy;
  const float* dth;
  const float* cnt;
  const float* invm;        // [Nt, T] consts
  const float* invi;
  const float* dynb;
  const float* kin;
  const float* l_px;        // [L] large-set pose
  const float* l_py;
  const float* l_an;
  const int32_t* pidx_c;    // [Nt, Cs, T]
  const float* sol;         // [Nt, TS_FIELDS, Cs, T]
  const float* lam;         // [Nt, 2, Cs, T]
  const float* gravity;     // [2]
  const float* tile_live;   // [Nt]
  float* o_px;              // [Nt, T] the substep's end state
  float* o_py;
  float* o_an;
  float* o_vx;
  float* o_vy;
  float* o_om;
  // compound rows (tile_substep.cu's compound instance only): the raw
  // velocity-pass sums [4, Nt, T], which the caller owner-sums, normalises
  // by the body's count and damps (owner_reduce.cu); null otherwise
  float* accv;
  const float* f;           // [Nt, T] TOI factors (the kCcd form), or null
  int Nt, Cs;
  float h, relaxation, max_dpos, rest_threshold;
  float lin_sdamp, ang_sdamp;  // 1 / (1 + h * damping)
  int use_lin_damp, use_ang_damp;
};

// The TOI factors of a substep (tile_substep.cu's K7, and K10's CCD
// phase): each bullet row's advance clamp over its solve slots.
struct TileCcdArgs {
  const float* px;          // [Nt, T] state at the substep's start
  const float* py;
  const float* an;
  const float* vx;
  const float* vy;
  const float* om;
  const float* dynb;        // [Nt, T] consts
  const float* blt;         // 1 on a bullet row
  const float* l_px;        // [L] large-set pose
  const float* l_py;
  const float* l_an;
  const int32_t* pidx_c;    // [Nt, Cs, T]
  const float* sol;         // [Nt, TS_FIELDS, Cs, T]
  const float* gravity;     // [2]
  const float* tile_live;   // [Nt]
  float* f;                 // [Nt, T] the factors, 1 where nothing clamps
  int Nt, Cs;
  float h, ccd_slop;
};

// The whole frame's substeps (tile_frame.cu). `project` and `apply` hold
// the first substep's arguments: their state pointers are the frame's
// input, `project`'s corrections, lam and touched (touched_in == touched,
// zeroed by the caller) are the frame's scratch, which `apply` reads. Later
// substeps swap in the ping-pong buffers: substep s reads the input (s = 0),
// else `st_b` (s odd) or `st_a` (s even), and writes `st_b` (s even) or
// `st_a` (s odd). Each buffer is px, py, an, vx, vy, om, [Nt, T] each.
// With CCD (`ccd.f` not null, and `project.f == apply.f == ccd.f`) each
// substep first writes the TOI factors into that scratch.
struct TileFrameArgs {
  TileProjectArgs project;
  TileApplyArgs apply;
  float* st_a[6];
  float* st_b[6];
  int substeps;
  TileCcdArgs ccd;
};

// The whole frame's substeps of a compound world (tile_compound_frame.cu):
// `frame` as for tile_frame.cu, but `frame.project`'s corrections are the
// raw row sums, which each substep owner-sums into `osum` [4, Nt, T]
// (`frame.apply`'s dxx, dxy, dth, cnt point there), `frame.apply.accv`
// [4, Nt, T] takes the velocity pass's raw sums, and with CCD `frame.ccd.f`
// takes the raw TOI factors, which each substep owner-mins into `f_own`
// (`frame.project.f == frame.apply.f == f_own`). `ob` [Nt * T] is each
// row's owner, in sibling blocks of at most `kc` rows.
struct TileCompoundFrameArgs {
  TileFrameArgs frame;
  float* osum;
  float* f_own;
  const int32_t* ob;
  int kc;
};

// The owner reductions of compound rows (owner_reduce.cu): rows of one body
// are contiguous in the tile layout and share `ob`, the owner body id
// (unique ids on padding rows), in blocks of at most `kc` rows.
struct OwnerSumArgs {
  const float* x[4];        // k per-row fields, [n] each
  float* y[4];              // their owner sums, broadcast to every row
  const int32_t* ob;        // [n]
  int k, n, kc;
};

struct OwnerVelocityArgs {
  const float* vx;          // [n] the apply phase's velocities
  const float* vy;
  const float* om;
  const float* accv;        // [4, n] its raw velocity-pass sums
  const int32_t* ob;        // [n]
  float* o_vx;              // [n] the substep's end velocities
  float* o_vy;
  float* o_om;
  int n, kc;
  float lin_sdamp, ang_sdamp;  // 1 / (1 + h * damping)
  int use_lin_damp, use_ang_damp;
};

// Candidate j of tile t: the flat row of a window candidate (j < 3T), or
// -1 - l for large-set slot l.
static __device__ __forceinline__ int tile_candidate(int t, int Nt, int j) {
  const int start = max(min(t - 1, Nt - TILE_WIN), 0);
  return j < TILE_WIN * TILE_T ? start * TILE_T + j
                               : -1 - (j - TILE_WIN * TILE_T);
}

// Warp-wide helpers of the ballot-ranking kernels (slots.cu, tile_tables.cu).
constexpr unsigned kFull = 0xffffffffu;

// (min lo x, max hi x, min lo y, max hi y) of box b over the warp's lanes;
// NaN bounds are ignored by fminf/fmaxf.
static __device__ __forceinline__ float4 warp_union(float4 b) {
  for (int o = 16; o > 0; o >>= 1) {
    b.x = fminf(b.x, __shfl_xor_sync(kFull, b.x, o));
    b.y = fmaxf(b.y, __shfl_xor_sync(kFull, b.y, o));
    b.z = fminf(b.z, __shfl_xor_sync(kFull, b.z, o));
    b.w = fmaxf(b.w, __shfl_xor_sync(kFull, b.w, o));
  }
  return b;
}

// v's inclusive prefix sum over the warp's lanes
static __device__ __forceinline__ uint32_t warp_inclusive(uint32_t v,
                                                          int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

#define SF_EXPORT(name, Args)                                     \
  extern "C" int name##_args_size() { return (int)sizeof(Args); }
