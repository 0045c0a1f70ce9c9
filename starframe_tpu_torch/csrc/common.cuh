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
  const int32_t* owner_start;  // [N + 1] world 0's collider->body CSR
  const int32_t* owner_idx;    // [M] colliders by body, ascending index
  float* scratch;           // [W, F2_FIELDS, C, M] per-slot frame constants
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
};

// Per-slot fields the frame kernel keeps in global scratch, each a [C, M]
// plane so that consecutive threads (rows i) read consecutive addresses.
enum Frame2Field {
  F2_NAX, F2_NAY,                       // body-local normal (own frame)
  F2_AAX0, F2_AAX1, F2_AAY0, F2_AAY1,   // body-local anchors on own body
  F2_BAX0, F2_BAX1, F2_BAY0, F2_BAY1,   // body-local anchors on partner
  F2_SM0, F2_SM1, F2_PM0, F2_PM1,       // solve mask, point mask
  F2_FRIC, F2_REST, F2_IMB, F2_IIB,     // pair friction/restitution, partner
  F2_WAX0, F2_WAX1, F2_WAY0, F2_WAY1,   // substep-start anchor world
  F2_WBX0, F2_WBX1, F2_WBY0, F2_WBY1,   //   positions (static friction)
  F2_LAM0, F2_LAM1,                     // accumulated normal lambda
  F2_FIELDS
};

#define SF_EXPORT(name, Args)                                     \
  extern "C" int name##_args_size() { return (int)sizeof(Args); }
