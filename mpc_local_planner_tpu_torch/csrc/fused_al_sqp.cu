// The fused whole-solve kernel: one whole warm AL-SQP solve per scenario, in
// one launch.
//
// Replaces the TPU kernel
// mpc_local_planner_tpu/ops/fused_al_sqp_pallas.py :: _fused_kernel on the
// scope the port admits: the models "unicycle", "simple_car",
// "front_wheel" and the kinematic bicycle (template parameter MODEL; the
// Pallas dyn branches), forward, midpoint or Crank-Nicolson differences or
// a shooting grid (template parameter COLLOC: forward differences, or the
// other rules read at run time; the Pallas defect, its
// midpoint and Crank-Nicolson branches with the closed -E^-1 fold, and
// _dyn_jvp, _axpy_jvp and _shoot_phi, the tableau read at run time), a
// footprint of one or two
// discs on the body axis, a body-frame segment or a body-frame polygon of
// at most 8 vertices, point, circle, line and polygon obstacle slots,
// static or moving (the Pallas obs_terms with fp_points, fp_segment,
// fp_polygon and their distance chains),
// minimum time, minimum time with via points or the quadratic form
// (template parameter OBJ; via points ordered or not, with an orientation
// weight, the Pallas via_sweep and via_rows; the quadratic form plain or
// integral, left-sum or trapezoidal, the hybrid time weight), the terminal
// quadratic cost, the terminal ball, and a uniform dt that is a decision
// variable or fixed at dt_ref, or the non-uniform grid of a per-stage dt
// (template parameter NONU, the Pallas nonu branches: dt_k a third control
// column of the step, a 3x3 Quu, the interval's dt box a stage row, the
// prediction times the cumulative sums of the stage dt). K2a (simple car,
// minimum time, variable dt, no ball, one disc at the pose, static circle
// slots) is the instantiation <T, SIMPLE_CAR, OBJ_MIN_TIME, GEO_NONE,
// false, COLLOC_FD>. Per scenario it computes:
//   per SQP iteration: the via points' stage assignment at the current
//     states (via points only), the closed-form linearization of the
//     collocation defect (the Riccati residual r = -E^-1 c, c in the merit
//     and the duals), the terminal P/p, the stage AL gradients and
//     Hessians streamed into the
//     backward Riccati sweep (2x2 Quu inverse, 3x3 on the non-uniform grid,
//     K/kff tape), the free dtau stage (variable uniform dt only), the
//     forward rollout, the NaN quarantine, the dt trust cap (the least over
//     the stages on the non-uniform grid, each stage's dt floored at dt_ref),
//     the candidate line search on the AL merit (alpha = 0
//     candidate last, first of equal merits wins; each candidate's via
//     cost from its own assignment) and the reg update;
//   per AL phase: the dual update with conditional rho growth and the
//     best-feasible snapshot;
//   at the end: the final selection and the objective.
// On a fixed dt the line search clips every candidate's dt, alpha = 0
// included, to [dt_ref, dt_ref], while the first linearization uses the
// lane's incoming dt (which the fleet cycle's resample shrinks): the JAX
// solver does the same.
// The plain PyTorch version of the same math is
// ops/fused_al_sqp_cuda.py :: fused_solve_plain.
//
// Bound on an H100: operations. Per scenario at N = 30, M = 8 the kernel
// reads 784 and writes 735 values (6 KB in float), but the solve needs about
// 0.79 MFLOP at a 3x4 budget with 3 candidates (k2a_flops in the wrapper
// counts them from this code, the Riccati step and the rollout on the
// structure of Fz, Gz and the stage Hessian): at B = 4096 that is 3.2 GFLOP,
// 48 us at the card's 67 TFLOP/s float32 peak, against 7 us for the bytes.
// The arithmetic is small-matrix algebra with no product a tensor core could
// take. This kernel runs the step as dense 6x6 products over the structural
// zeros and ones (about four times the step's operations, 1.7 times the
// whole solve's); folding them as the TPU kernel does is left for later.
//
// Design: a team of TEAM lanes of one warp (a whole warp, 32 lanes) solves
// one scenario; TEAMS teams share a block of
// BLOCK = 64 threads, so that the fleet cycle's batches put several warps on
// every SM (a batch of 1024 fills 512 blocks). The lanes take the stages in
// turn (lane l the stages k = l mod TEAM) wherever the stages are
// independent: the stage terms of the backward sweep (transition and
// stage_grad_hess, the whole geometry gradient), each candidate's merit
// (summed over the team by a butterfly of shuffles), the step's
// application, the dual update with its violation maxima (vmax and vmin
// over the team, which keep a NaN), the best-feasible snapshot, the final
// selection and the cost; the via points' assignment is an argmin over the
// team, the ordered cursor serial over the slots. Only the Riccati
// recursion and the rollout carry a dependence from stage to stage: the
// backward sweep walks chunks of TEAM items from the last (item k < N stage
// k's terms, computed by its lane into the chunk's slot; item N the terminal
// P, p), and each stage of the recursion spreads the entries of its 6x6
// (6xNV) products over the lanes, each a dot product of length 6 read from
// shared memory, in three phases between team barriers (riccati_stage); the
// rollout forms a chunk's transitions on the lanes, then lanes 0-5 each
// carry one row of z, one barrier per stage. The NaN quarantine is a team
// vote. Every team barrier is a __syncwarp over the team's lanes, and every
// lane of a team runs the same sequence of them.
// The model and the objective family are template parameters, so the inner
// loops carry no branch on them; the objective's forms (integral,
// trapezoidal, hybrid), Qf, the ball and a fixed dt are runtime flags that
// every team of a launch shares. The geometry (disc count and offsets,
// slot-family counts, vertex pad, dynamic flag, the footprint's body-frame
// points) is runtime too, but the template parameter GEO compiles away what
// a launch needs none of and makes the footprint's kind compile-time:
// GEO_NONE (one disc at the pose, static point and circle slots, the
// flagship and config #2) keeps the registers of a kernel without the
// geometry, GEO_ALL reads every part at run time; a segment or a polygon
// footprint has instantiations of its own (GEO_FP_LINE, GEO_FP_POLYGON),
// so its edge loops never land in the disc ones. Via points are a third
// value of the objective parameter OBJ, so they never land in the other
// instantiations. The polygon's body-frame
// vertices stay in the launch's parameters (the constant bank, read in
// place through a __grid_constant__ parameter); each world edge is formed
// where it is needed from one cos / sin per pose. Five instantiations per
// (type, model, objective family, grid, collocation family): 480 in all.
// One build compiles the five of one such group, named by the macros
// K2A_DOUBLE, K2A_MODEL, K2A_OBJ, K2A_NONU and K2A_COLLOC: the wrapper
// builds each group it needs into a library of its own (96 at most), many
// at once, and loads the one a launch needs. The kernel is a template over
// float and double, so that the card can check the algorithm in f64, free
// of f32 noise.
//
// N, M and the number of line-search candidates are runtime arguments with
// no cap, as in the TPU kernel. A team copies its scenario's contiguous
// input rows into its working state with neighbouring lanes on
// neighbouring values, and writes the outputs back the same way. The
// working state (Layout): the via points' stage indices and the scratch of
// the Riccati step always in the team's slice of the block's shared memory;
// then the primal, the chunk of stage terms, the gain tape, the step, the
// duals, the best-feasible snapshot and the prediction times, each in the
// slice while the team's budget (SMEM_TEAM_F32 bytes in float, twice that in
// double) holds it, else in its output tensor (the primal and the duals,
// worked on in place) or in a workspace the wrapper allocates, ws values per
// scenario, scenario-major, so that a team's accesses coalesce. The
// candidates are a device input of n_alpha values in the working type.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream and returns cudaGetLastError() (0 on success).

#include <cfloat>
#include <climits>
#include <cmath>
#include <cuda_runtime.h>
#include <type_traits>

// the group of instantiations this build compiles (nvcc -D...): the
// working type (K2A_DOUBLE: 0 float, 1 double), the model (K2A_MODEL, a
// ModelId), the objective family (K2A_OBJ, an Objective) and the grid
// (K2A_NONU: 0 the uniform grid, 1 the non-uniform grid of a per-stage dt)
// and the collocation family (K2A_COLLOC, a CollocFamily)
#ifndef K2A_DOUBLE
#define K2A_DOUBLE 0
#endif
#ifndef K2A_MODEL
#define K2A_MODEL 1
#endif
#ifndef K2A_OBJ
#define K2A_OBJ 0
#endif
#ifndef K2A_NONU
#define K2A_NONU 0
#endif
#ifndef K2A_COLLOC
#define K2A_COLLOC 0
#endif

// the block's shared memory: one slice per team (Layout)
extern __shared__ __align__(16) unsigned char k2a_smem[];

namespace {

constexpr int NX = 3;
constexpr int NU = 2;
constexpr int NA = 6;  // z = [dx (3), du_prev (2), dtau]
constexpr int MAX_V = 16;  // padded polygon vertices (JAX fused_obstacles_supported)
constexpr int MAX_VIA = 8;  // via points (JAX fused_supported)
constexpr int TAPE = NU * NA + NU;  // one stage of the gain tape: K (2x6), kff (2)
constexpr int NV3 = NU + 1;  // the non-uniform grid's control width: [du, ddt]
constexpr int TAPE3 = NV3 * NA + NV3;  // its gain tape: K (3x6), kff (3)
constexpr double BIG = 1.0e6;   // geometry.obstacles.BIG_DISTANCE
constexpr double EPS = 1.0e-12; // geometry.distances._EPS (safe norm)
constexpr double PI = 3.141592653589793;
constexpr double TWO_PI = 6.283185307179586;

// the MODEL template parameter (ops/fused_al_sqp_cuda.py MODEL_IDS)
enum ModelId { UNICYCLE = 0, SIMPLE_CAR = 1, FRONT_WHEEL = 2, BICYCLE = 3 };

// the OBJ template parameter: the objective family
enum Objective { OBJ_MIN_TIME = 0, OBJ_QUADRATIC = 1, OBJ_VIA = 2 };

// ---- the launch: teams of TEAM lanes, TEAMS teams in a block of BLOCK
// threads, each team's working state in a slice of the block's shared
// memory (Layout). The team size and the team's shared budget in float
// (twice that in double) were measured (fused_probe.py teams, which builds
// this source with other values of the two): a team of 32 lanes at 18,944
// bytes puts 12 teams on an SM, the most that 168 registers a thread allow
constexpr int TEAM = 32;
static_assert(TEAM == 8 || TEAM == 16 || TEAM == 32, "a team is 8, 16 or 32 lanes of a warp");
constexpr int SMEM_TEAM_F32 = 18944;
constexpr int BLOCK = 64;
constexpr int TEAMS = BLOCK / TEAM;
constexpr int SMEM_BLOCK = 232448;  // the most shared memory a block can have (227 KB)
constexpr int SMEM_SM = 233472;     // an SM's shared memory (228 KB), 1 KB of it kept per block
constexpr int VKS_BYTES = 32;         // the via points' stage indices (MAX_VIA ints)

// the team's scratch (values of the working type, after the vks): the
// Riccati step's blocks (P, p; PF, PG, Prp; Qzz, Qzu, qz, Quu, qu: at the
// widths of the non-uniform grid's three control columns), the rollout's z
// (twice), the terminal multipliers lam_term and mu_ball
constexpr int S_P = 0, S_PV = 36, S_PF = 42, S_PG = 78, S_PRP = 96, S_QZZ = 102, S_QZU = 138,
              S_QZ = 156, S_QUU = 162, S_QU = 171, S_Z = 174, S_LT = 186, S_MBALL = 189,
              SCRATCH = 192;

// one stage's terms in a chunk slot: Fz (6x6), Gz (6xNV), rz (6), Hzz
// (6x6), Hzu (6xNV), Huu (NVxNV), hz (6), hu (NV), the slot's stride odd
__host__ __device__ constexpr int slot_values(bool nonu) {
  const int nv = nonu ? NV3 : NU;
  return (NA * NA * 2 + NA * 2 + 2 * NA * nv + nv * nv + nv) | 1;
}

// the arrays of a team's working state, in the order they claim shared
// memory: the primal, then what the serial recursion and rollout read (the
// chunk of stage terms, the gain tape), the step, the duals, the
// best-feasible snapshot, the prediction times
enum Arr {
  A_XS, A_US, A_DTS, A_CHUNK, A_TAPE, A_DXS, A_DUS, A_DTAUS, A_LD, A_MR, A_MB, A_MD, A_MO,
  A_BXS, A_BUS, A_BDTS, A_TV, N_ARR
};

// values of each array: xs and the snapshot (N+1) x 3, us N x 2, the
// non-uniform grid's per-stage dt N (its step's and its snapshot's too),
// a chunk TEAM slots, the gain tape N x TAPE (TAPE3 on the non-uniform
// grid), lam_def N x 3, mu_rate and mu_box N x 4, mu_dt 2 (2N on the
// non-uniform grid), mu_obs N x M, the prediction times N + 1
inline int arr_values(int arr, int N, int M, bool nonu) {
  switch (arr) {
    case A_XS: case A_DXS: case A_BXS: return (N + 1) * NX;
    case A_US: case A_DUS: case A_BUS: return N * NU;
    case A_DTS: case A_DTAUS: case A_BDTS: return nonu ? N : 0;
    case A_CHUNK: return TEAM * slot_values(nonu);
    case A_TAPE: return N * (nonu ? TAPE3 : TAPE);
    case A_LD: return N * NX;
    case A_MR: case A_MB: return N * 4;
    case A_MD: return nonu ? 2 * N : 2;
    case A_MO: return N * M;
    default: return nonu ? N + 1 : 0;  // A_TV
  }
}
// the arrays with an output tensor: where they do not fit in shared
// memory, the kernel works on them in place there
inline bool has_output(int arr) {
  return arr == A_XS || arr == A_US || arr == A_DTS || arr == A_LD || arr == A_MR ||
         arr == A_MB || arr == A_MD || arr == A_MO;
}

// Where a team's working state lives: the vks and the scratch always in
// its shared slice; then each array, in the order of Arr, in the slice
// while the team's budget holds it, else in its output tensor or, for the
// step, the chunk, the tape, the snapshot and the prediction times, in the
// scenario's workspace (ws values per scenario, scenario-major)
struct Layout {
  int team_bytes;   // the team's shared bytes
  int ws;           // workspace values per scenario
  int shared;       // bit a: array a lives in shared memory
  int off[N_ARR];   // its offset in values: in the slice (after the vks), or in the workspace
};

// a team's shared budget in bytes: SMEM_TEAM_F32 in float, twice that in
// double, at most a block's share
__host__ __device__ constexpr int team_budget(int tsize) {
  return SMEM_TEAM_F32 * tsize / 4 < SMEM_BLOCK / TEAMS ? SMEM_TEAM_F32 * tsize / 4
                                                        : SMEM_BLOCK / TEAMS;
}

inline Layout make_layout(int N, int M, bool nonu, int tsize) {
  Layout lay = {};
  const int budget = team_budget(tsize);
  long used = SCRATCH;
  for (int arr = 0; arr < N_ARR; ++arr) {
    const long n = arr_values(arr, N, M, nonu);
    if (VKS_BYTES + (used + n) * tsize <= budget) {
      lay.shared |= 1 << arr;
      lay.off[arr] = static_cast<int>(used);
      used += n;
    } else if (!has_output(arr)) {
      lay.off[arr] = lay.ws;
      lay.ws += static_cast<int>(n);
    }
  }
  lay.team_bytes = static_cast<int>((VKS_BYTES + used * tsize + 15) / 16 * 16);
  return lay;
}

// the GEO template parameter: the parts of the geometry an instantiation
// reads at run time; a part left out is compiled away. The footprint's
// kind is compile-time too: the disc family (no bit), a body-frame segment
// (GEO_FP_LINE) or a body-frame polygon (GEO_FP_POLYGON). The entry points
// launch GEO_NONE or GEO_ALL for disc-family footprints, GEO_FP_LINE |
// GEO_SLOTS for a segment, and GEO_FP_POLYGON (static point and circle
// slots) or GEO_FP_POLYGON | GEO_SLOTS for a polygon; the parts between
// them only measure what each part costs in registers.
enum GeoParts {
  GEO_NONE = 0,
  GEO_DISCS = 1,     // a second disc, discs off the pose (theta rows)
  GEO_LINES = 2,     // line slots
  GEO_POLYGONS = 4,  // polygon slots
  GEO_DYNAMIC = 8,   // moving slots
  GEO_ALL = 15,
  GEO_SLOTS = 14,    // line and polygon slots, moving slots
  GEO_FP_LINE = 16,     // the footprint is a body-frame segment
  GEO_FP_POLYGON = 32,  // the footprint is a body-frame polygon
};

// the footprint kinds of K2aParams::fp_kind (ops/fused_al_sqp_cuda.py)
enum FootprintKind { FP_DISCS = 0, FP_LINE = 1, FP_POLYGON = 2 };
constexpr int MAX_FP_V = 8;  // polygon footprint vertices (JAX fused_supported)

// the COLLOC template parameter: the collocation family
// (ops/fused_al_sqp_cuda.py COLLOC_FAMILY): forward differences, or the
// other rules (the -E^-1 fold of midpoint and Crank-Nicolson, the shooting
// grids' tableau walk), the rule and the tableau read at run time, so that
// one library holds them all
enum CollocFamily { COLLOC_FD = 0, COLLOC_OTHER = 1 };
// the rules of K2aParams::colloc (ops/fused_al_sqp_cuda.py COLLOC_IDS)
enum CollocRule { RULE_FORWARD = 0, RULE_MIDPOINT = 1, RULE_CRANK_NICOLSON = 2, RULE_SHOOTING = 3 };
// a shooting grid's integrator (JAX fused_supported): at most MAX_RK
// tableau stages (rk7), MAX_SUBSTEPS substeps, MAX_RK_EVALS dynamics
// evaluations per stage of the grid
constexpr int MAX_RK = 11;
constexpr int MAX_SUBSTEPS = 4;
constexpr int MAX_RK_EVALS = 28;
// the entries of one RK stage's tangent that can be nonzero: rows 0-1 at
// columns theta0, u0, u1, dt (jx_i times the state's theta row, plus Ju),
// row 2 at u0, u1 (Ju)
constexpr int KT = 10;

}  // namespace

// Static problem and solver constants, by value (doubles; the kernel rounds
// them to its working type, as the plain version's tensors do).
struct K2aParams {
  int N, M, n_al, n_sqp, n_alpha;
  int xf_fixed[3];
  int model, quadratic;  // the template parameters of the instantiation (with mv)
  int integral, trapezoidal, has_qf, variable_dt;
  // obstacle slots: Mc point and circle slots, Ml line slots, Mg polygon
  // slots of V padded vertices (M = Mc + Ml + Mg, in that row order); the
  // footprint: fp_kind FP_DISCS as n_disc (1 or 2) discs on the body
  // x-axis, FP_LINE as the body-frame segment fp_v[0] -> fp_v[1] (fp_nv =
  // 2), FP_POLYGON as the closed body-frame polygon fp_v[0 .. fp_nv - 1]
  // (1 to MAX_FP_V vertices, as JAX fused_supported: at 2 the segment walked
  // out and back, whose two edges' crossings cancel, at 1 a point, its one
  // edge of no length); dynamic: slots move at their velocities
  int Mc, Ml, Mg, V, n_disc, dynamic, fp_kind, fp_nv;
  double wheelbase, bike_a, bike_lr, disc_off[2], disc_r[2], fp_v[MAX_FP_V][2], min_dist;
  double lo_u[2], hi_u[2], lo_r[2], hi_r[2];  // rate limits sanitized to +-BIG
  double q[3], r[2], qf[3], hybrid, ball_w[3], ball_r;
  double dt_min, dt_max, dt_lo, dt_hi;
  // via points (minimum_time_via_points): mv slots (0 for the other
  // objectives), ordered or not, position and orientation weights
  int mv, via_ordered;
  double via_pw, via_ow;
  double dt_trust_frac, rho_growth, rho_max;
  double reg0, reg_shrink, reg_grow, reg_min, reg_max;
  double viol_decrease_req, tol_eq, tol_ineq;
  // the non-uniform grid (the template parameter NONU of the launch): the
  // trust cap's floor dt_ref and the ddt column's proximal weight
  int nonu;
  double dt_ref, dt_prox;
  // the collocation rule (a CollocRule); a shooting grid's tableau: rk_a[s]
  // holds stage s's a entries (s = 1 .. rk_stages - 1), rk_b the weights
  int colloc, rk_stages, rk_substeps;
  double rk_a[MAX_RK][MAX_RK], rk_b[MAX_RK];
};

namespace {

template <typename T>
struct K2aArgs {
  // inputs
  const T *xs_i, *us_i, *dt_i, *xf, *u_prev;
  const T *oc, *orad, *ovel;        // point and circle slots: (B,Mc,2), (B,Mc), (B,Mc,2)
  const unsigned char* omask;       // (B,Mc) bool
  const T *ln, *lvel;               // line slots: endpoints (B,Ml,2,2), velocities (B,Ml,2)
  const unsigned char* lmask;       // (B,Ml) bool
  const T *pg, *pvel;               // polygon slots: vertices (B,Mg,V,2), velocities (B,Mg,2)
  const int* pnv;                   // (B,Mg) active vertex counts
  const unsigned char* pmask;       // (B,Mg) bool
  const T *ld_i, *lt_i, *mo_i, *mr_i, *mb_i, *md_i, *mball_i, *rho_i;
  const T* vp;                      // via points (B,mv,3)
  const unsigned char* vmask;       // (B,mv) bool
  const T* alphas;                  // the line-search candidates (n_alpha)
  T* ws;                            // the workspace (B, Layout::ws), scenario-major
  // outputs: the working state, updated in place
  T *xs, *us, *dt, *ld, *lt, *mo, *mr, *mb, *md, *mball, *rho;
  T *cost, *eq, *ineq;
  unsigned char* conv;
  int B;
};

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny<double>() { return DBL_MIN; }
template <typename T> __device__ __forceinline__ T largest();
template <> __device__ __forceinline__ float largest<float>() { return FLT_MAX; }
template <> __device__ __forceinline__ double largest<double>() { return DBL_MAX; }

// max / min that keep a NaN, like torch.maximum / torch.minimum
template <typename T> __device__ __forceinline__ T vmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T vmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T hinge(T t) { return vmax(T(0), t); }

// a product rounded on its own (never contracted into a fused multiply-add),
// as PyTorch forms a sum of squares
template <typename T> __device__ __forceinline__ T mul_rn(T a, T b);
template <> __device__ __forceinline__ float mul_rn<float>(float a, float b) {
  return __fmul_rn(a, b);
}
template <> __device__ __forceinline__ double mul_rn<double>(double a, double b) {
  return __dmul_rn(a, b);
}
template <typename T> __device__ __forceinline__ T clip(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// AL curvature weight of an exactly penalized linear inequality: the
// Hessian of max(0, t)^2 / (2 rho) with the 0.5 tie subgradient of maximum,
// so an exactly active row (t == 0) weighs rho / 4.
template <typename T> __device__ __forceinline__ T hinge_w(T t, T rho) {
  const T s = t > T(0) ? T(1) : (t == T(0) ? T(0.5) : T(0));
  return rho * s * s;
}

// theta wrap to [-pi, pi) with torch.remainder's (jnp.mod's) sign rule
template <typename T> __device__ __forceinline__ T wrap(T th) {
  T m = fmod(th + T(PI), T(TWO_PI));
  if (m != T(0) && m < T(0)) m += T(TWO_PI);
  return m - T(PI);
}

// the footprint at one pose. Discs: centers and their theta derivatives;
// a segment: its ends A = (px[0], py[0]) and B = (px[1], py[1]) and their
// theta derivatives; a polygon: the pose's position (px[0], py[0]) and
// cos / sin of its heading, from which each world edge is formed on the fly
template <typename T>
struct Foot {
  T px[2], py[2], dpx[2], dpy[2], c, s;
};

// a footprint segment that moves with the pose: ends A, B and their theta
// derivatives (the Pallas kernel's (A, B, Ath, Bth))
template <typename T>
struct Seg {
  T ax, ay, bx, by, tax, tay, tbx, tby;
};

// the non-uniform grid's per-lane state: the working per-stage dt (where
// Layout puts it), the trust cap's floor, the ddt column's proximal weight;
// empty on the uniform grid
template <typename T, bool NONU>
struct NonuState {
  T* dts;
  T dt_ref, dt_prox;
};
template <typename T>
struct NonuState<T, false> {};

// the collocation family's per-lane state: the rule (a CollocRule) and a
// shooting grid's tableau in the launch's parameters (COLLOC_OTHER); empty
// under forward differences
template <int COLLOC>
struct CollocState {};
template <>
struct CollocState<COLLOC_OTHER> {
  int rule, rk_stages, rk_substeps;
  const double (*rk_a)[MAX_RK];  // read in place, as fp_v
  const double* rk_b;
};

template <typename T, int MODEL, int OBJ, int GEO, bool NONU, int COLLOC>
struct Lane : NonuState<T, NONU>, CollocState<COLLOC> {
  static constexpr bool QUAD = OBJ == OBJ_QUADRATIC;
  static constexpr bool VIA = OBJ == OBJ_VIA;
  static constexpr int NV = NONU ? NV3 : NU;          // the step's control width
  static constexpr int TAPE_L = NONU ? TAPE3 : TAPE;  // one stage of the gain tape
  int N, M, Mc, Ml, Mg, V, n_disc;
  bool dynamic, rot;  // rot: a disc sits off the pose (theta-dependent rows)
  T disc_off[2], disc_r[2];
  T wb, bike_a, bike_lr, min_dist, dt_min, dt_max, dt_lo, dt_hi, dt0;
  T lo_u[NU], hi_u[NU], lo_r[NU], hi_r[NU];
  T q[NX], r[NU], qf[NX], hybrid, ball_w[NX], ball_r;
  bool fixed[NX], integral, trapezoidal, has_qf, ball_on, vdt;
  int fp_nv;                  // polygon footprint vertices
  const double (*fp_v)[2];    // body-frame footprint points (the launch's parameters)
  const T *xf, *u_prev, *oc, *orad, *ovel, *ln, *lvel, *pg, *pvel;
  const unsigned char *omask, *lmask, *pmask;
  const int* pnv;
  T *xs, *us, *ld, *lt, *mo, *mr, *mb, *md, *mball;
  T dt, rho, dtau;
  // via points: mv slots at vp with mask vm, the stage each claims (vks)
  int mv;
  bool via_ordered;
  T via_pw, via_ow;
  const T* vp;
  const unsigned char* vm;
  int* vks;  // (in the team's shared slice)
  // the team: this lane's index in it and the team's lanes in the warp; the
  // scratch (the Riccati step's blocks), the chunk of stage terms, the step
  // (dxs, dus, on the non-uniform grid dtaus), the gain tape, the snapshot
  // (bxs, bus, bdts) and the prediction times tv, where Layout puts them
  int lane;
  unsigned mask;
  T *sc, *chunk, *dxs_p, *dus_p, *dtaus_p, *tape, *bxs_p, *bus_p, *bdts_p, *tv_p;
  // a chunk slot's blocks (slot_values)
  static constexpr int O_FZ = 0, O_GZ = NA * NA, O_RZ = O_GZ + NA * NV, O_HZZ = O_RZ + NA,
                       O_HZU = O_HZZ + NA * NA, O_HUU = O_HZU + NA * NV, O_HZ = O_HUU + NV * NV,
                       O_HU = O_HZ + NA, SVP = slot_values(NONU);
  static_assert(O_HU + NV <= SVP, "a chunk slot holds one stage's terms");

  __device__ __forceinline__ T& dxs(int k, int i) const { return dxs_p[k * NX + i]; }
  __device__ __forceinline__ T& dus(int k, int i) const { return dus_p[k * NU + i]; }
  __device__ __forceinline__ T& Kt(int k, int i, int j) const {
    return tape[k * TAPE_L + i * NA + j];
  }
  __device__ __forceinline__ T& kft(int k, int i) const { return tape[k * TAPE_L + NV * NA + i]; }
  __device__ __forceinline__ T& bxs(int k, int i) const { return bxs_p[k * NX + i]; }
  __device__ __forceinline__ T& bus(int k, int i) const { return bus_p[k * NU + i]; }
  // the non-uniform grid: the step's ddt_k, the snapshot's dt_k, the
  // prediction time of pose i at the solve's initial dt (sum_{j<i} dt_j)
  __device__ __forceinline__ T& dtaus(int k) const { return dtaus_p[k]; }
  __device__ __forceinline__ T& bdts(int k) const { return bdts_p[k]; }
  __device__ __forceinline__ T& tv(int i) const { return tv_p[i]; }

  // the dt of stage k: the shared dt, or the stage's own on the non-uniform
  // grid
  __device__ __forceinline__ T dt_at(int k) const {
    if constexpr (NONU) return this->dts[k];
    return dt;
  }

  __device__ __forceinline__ void x_at(int k, T x[NX]) const {
    for (int i = 0; i < NX; ++i) x[i] = xs[k * NX + i];
  }
  __device__ __forceinline__ void u_at(int k, T u[NU]) const {
    for (int i = 0; i < NU; ++i) u[i] = us[k * NU + i];
  }
  // u_{k-1}, with u_{-1} = the scenario's u_prev
  __device__ __forceinline__ void uprev_at(int k, T u[NU]) const {
    for (int i = 0; i < NU; ++i) u[i] = k == 0 ? u_prev[i] : us[(k - 1) * NU + i];
  }

  // the model's f(x, u); the theta column of Jx (its only nonzero column);
  // Ju (the Pallas kernel's dyn branches)
  __device__ __forceinline__ void dyn(const T x[NX], const T u[NU], T f[NX], T jx[2],
                                      T ju[NX][NU]) const {
    const T v = u[0];
    if constexpr (MODEL == UNICYCLE) {
      const T c = cos(x[2]), s = sin(x[2]);
      f[0] = v * c;
      f[1] = v * s;
      f[2] = u[1];
      jx[0] = -v * s;
      jx[1] = v * c;
      ju[0][0] = c;
      ju[0][1] = T(0);
      ju[1][0] = s;
      ju[1][1] = T(0);
      ju[2][0] = T(0);
      ju[2][1] = T(1);
    } else if constexpr (MODEL == SIMPLE_CAR) {
      const T c = cos(x[2]), s = sin(x[2]), t = tan(u[1]);
      f[0] = v * c;
      f[1] = v * s;
      f[2] = v * t / wb;
      jx[0] = -v * s;
      jx[1] = v * c;
      ju[0][0] = c;
      ju[0][1] = T(0);
      ju[1][0] = s;
      ju[1][1] = T(0);
      ju[2][0] = t / wb;
      ju[2][1] = v * (T(1) + t * t) / wb;
    } else if constexpr (MODEL == FRONT_WHEEL) {
      // the speed is measured at the steered front axle: v cos(phi) along
      // the body
      const T c = cos(x[2]), s = sin(x[2]), cp = cos(u[1]), sp = sin(u[1]);
      const T vl = v * cp;
      f[0] = vl * c;
      f[1] = vl * s;
      f[2] = v * sp / wb;
      jx[0] = -vl * s;
      jx[1] = vl * c;
      ju[0][0] = cp * c;
      ju[0][1] = -v * sp * c;
      ju[1][0] = cp * s;
      ju[1][1] = -v * sp * s;
      ju[2][0] = sp / wb;
      ju[2][1] = v * cp / wb;
    } else {
      // kinematic bicycle: beta = atan(a tan(delta)), a = lr / (lf + lr),
      // dbeta/ddelta = a (1 + t^2) / (1 + (a t)^2)
      const T t = tan(u[1]);
      const T at = bike_a * t;
      const T beta = atan(at);
      const T dbeta = bike_a * (T(1) + t * t) / (T(1) + at * at);
      const T cb = cos(x[2] + beta), sb = sin(x[2] + beta);
      const T sbe = sin(beta), cbe = cos(beta);
      f[0] = v * cb;
      f[1] = v * sb;
      f[2] = v * sbe / bike_lr;
      jx[0] = -v * sb;
      jx[1] = v * cb;
      ju[0][0] = cb;
      ju[0][1] = -v * sb * dbeta;
      ju[1][0] = sb;
      ju[1][1] = v * cb * dbeta;
      ju[2][0] = sbe / bike_lr;
      ju[2][1] = v * cbe * dbeta / bike_lr;
    }
  }

  // x (-) xf: the SE(2) difference to the goal, theta wrapped
  __device__ __forceinline__ void goal_dx(const T x[NX], T d[NX]) const {
    d[0] = x[0] - xf[0];
    d[1] = x[1] - xf[1];
    d[2] = wrap(x[2] - xf[2]);
  }

  // the quadratic form's stage cost at stage k: lx + lu (plain) or
  // (iw lx + lu) dt (integral; iw = 1/2 at k = 0 under the trapezoidal rule),
  // plus hybrid * dt; on the non-uniform grid the trapezoidal stage is
  // 1/2 (dtp + dt) lx + lu dt, dtp = dt_{k-1} (0 at k = 0)
  __device__ __forceinline__ T stage_cost(const T x[NX], const T u[NU], T dtv, int k,
                                          T dtp = T(0)) const {
    T d[NX];
    goal_dx(x, d);
    const T lx = q[0] * d[0] * d[0] + q[1] * d[1] * d[1] + q[2] * d[2] * d[2];
    const T lu = r[0] * u[0] * u[0] + r[1] * u[1] * u[1];
    T c;
    if (NONU && integral && trapezoidal) {
      c = T(0.5) * (dtp + dtv) * lx + lu * dtv;
    } else if (integral) {
      const T iw = (trapezoidal && k == 0) ? T(0.5) : T(1);
      c = (iw * lx + lu) * dtv;
    } else {
      c = lx + lu;
    }
    if (hybrid > T(0)) c += hybrid * dtv;
    return c;
  }

  // the terminal terms of the objective: Qf, and the 1/2 dt lx(x_N) tail of
  // the trapezoidal rule
  __device__ __forceinline__ T terminal_cost(const T xN[NX], T dtv) const {
    T d[NX];
    goal_dx(xN, d);
    T c = T(0);
    if (QUAD && integral && trapezoidal)
      c += T(0.5) * (q[0] * d[0] * d[0] + q[1] * d[1] * d[1] + q[2] * d[2] * d[2]) * dtv;
    if (has_qf) c += qf[0] * d[0] * d[0] + qf[1] * d[1] * d[1] + qf[2] * d[2] * d[2];
    return c;
  }

  // the terminal ball row g = sum_i w_i d_i^2 - r^2 and its pose gradient
  __device__ __forceinline__ T ball_g(const T xN[NX], T gp[NX]) const {
    T d[NX];
    goal_dx(xN, d);
    T g = -ball_r * ball_r;
    for (int i = 0; i < NX; ++i) {
      g += ball_w[i] * d[i] * d[i];
      gp[i] = T(2) * ball_w[i] * d[i];
    }
    return g;
  }

  // ---- the collocation rules other than forward differences (the Pallas
  // defect's midpoint, Crank-Nicolson and shooting branches)

  // midpoint: f, Jx and Ju at the SE(2) midpoint ((x_k + x_{k+1}) / 2,
  // wrap(theta_k + wrap(theta_{k+1} - theta_k) / 2)), so ja = je;
  // Crank-Nicolson: f = (f(x_k) + f(x_{k+1})) / 2, ja at x_k, je at x_{k+1},
  // bu = (Ju(x_k) + Ju(x_{k+1})) / 2
  __device__ __forceinline__ void fold_dyn(const T xk[NX], const T uk[NU], const T xk1[NX],
                                           T f[NX], T ja[2], T je[2], T bu[NX][NU]) const {
    if (this->rule == RULE_MIDPOINT) {
      const T xm[NX] = {T(0.5) * (xk[0] + xk1[0]), T(0.5) * (xk[1] + xk1[1]),
                        wrap(xk[2] + T(0.5) * wrap(xk1[2] - xk[2]))};
      dyn(xm, uk, f, ja, bu);
      je[0] = ja[0];
      je[1] = ja[1];
    } else {
      T fb[NX], jub[NX][NU];
      dyn(xk, uk, f, ja, bu);
      dyn(xk1, uk, fb, je, jub);
      for (int i = 0; i < NX; ++i) {
        f[i] = T(0.5) * (f[i] + fb[i]);
        for (int j = 0; j < NU; ++j) bu[i][j] = T(0.5) * (bu[i][j] + jub[i][j]);
      }
    }
  }

  // one stage's k = f(y, u) and, TANGENT, the nonzero entries of its
  // tangent (KT): rows 0-1 jx_i (1, t3, t4, t5) + (0, Ju_i0, Ju_i1, 0) at
  // columns theta0, u0, u1, dt, row 2 (Ju_20, Ju_21) at u0, u1, where yt =
  // (t3, t4, t5) is the theta row of y's tangent (every model's Jx has only
  // a theta column, so rows 0-1 of y's tangent do not enter)
  template <bool TANGENT>
  __device__ __forceinline__ void rk_stage(const T y[NX], const T yt[3], const T uk[NU], T k[NX],
                                           T kt[KT]) const {
    T jx[2], ju[NX][NU];
    dyn(y, uk, k, jx, ju);
    if constexpr (TANGENT) {
      for (int i = 0; i < 2; ++i) {
        kt[4 * i] = jx[i];
        kt[4 * i + 1] = jx[i] * yt[0] + ju[i][0];
        kt[4 * i + 2] = jx[i] * yt[1] + ju[i][1];
        kt[4 * i + 3] = jx[i] * yt[2];
      }
      kt[8] = ju[2][0];
      kt[9] = ju[2][1];
    }
  }

  // y += (c h) k and, TANGENT, its tangent: rows 0-1 (ys: columns theta0,
  // u0, u1, dt) += (c h) kt + (c / substeps) k_i at dt, the theta row yt
  // (u0, u1, dt) likewise
  template <bool TANGENT>
  __device__ __forceinline__ void rk_axpy(T ch, T cdh, const T k[NX], const T kt[KT], T y[NX],
                                          T ys[2][4], T yt[3]) const {
    for (int i = 0; i < NX; ++i) y[i] = y[i] + ch * k[i];
    if constexpr (TANGENT) {
      for (int i = 0; i < 2; ++i) {
        for (int j = 0; j < 3; ++j) ys[i][j] = ys[i][j] + ch * kt[4 * i + j];
        ys[i][3] = ys[i][3] + (ch * kt[4 * i + 3] + cdh * k[i]);
      }
      yt[0] = yt[0] + ch * kt[8];
      yt[1] = yt[1] + ch * kt[9];
      yt[2] = yt[2] + cdh * k[2];
    }
  }

  // the shooting prediction Phi(x_k, u_k, dt) by the walk of the tableau (h
  // = dt / substeps; per nonzero entry c of a row or of b, y += (c h) k;
  // the plain version's shoot) and, TANGENT, its tangent over w = [x_k,
  // u_k, dt] on its structure: rows 0-1 are [I | xs_t_i], row 2 is [0, 0,
  // 1 | xt]; the stages' k and tangents live in per-lane arrays (local
  // memory: the stage count is a runtime value)
  template <bool TANGENT>
  __device__ void shoot(const T xk[NX], const T uk[NU], T dtv, T xv[NX], T xs_t[2][4],
                        T xt[3]) const {
    const int ns = this->rk_stages, nsub = this->rk_substeps;
    const T h = nsub > 1 ? dtv / T(nsub) : dtv;
    const double dh = 1.0 / nsub;
    T kv[MAX_RK][NX], kt[MAX_RK][KT], zt[3] = {T(0), T(0), T(0)};
    T* const xtp = TANGENT ? xt : zt;
    for (int i = 0; i < NX; ++i) xv[i] = xk[i];
    if constexpr (TANGENT) {
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 4; ++j) xs_t[i][j] = T(0);
      for (int j = 0; j < 3; ++j) xt[j] = T(0);
    }
#pragma unroll 1
    for (int sub = 0; sub < nsub; ++sub) {
#pragma unroll 1
      for (int st = 0; st < ns; ++st) {
        T y[NX], ys[2][4], yt[3];
        for (int i = 0; i < NX; ++i) y[i] = xv[i];
        for (int j = 0; j < 3; ++j) yt[j] = xtp[j];
        if constexpr (TANGENT)
          for (int i = 0; i < 2; ++i)
            for (int j = 0; j < 4; ++j) ys[i][j] = xs_t[i][j];
#pragma unroll 1
        for (int j = 0; j < st; ++j) {
          const double c = this->rk_a[st][j];
          if (c != 0.0) rk_axpy<TANGENT>(T(c) * h, T(c * dh), kv[j], kt[j], y, ys, yt);
        }
        rk_stage<TANGENT>(y, yt, uk, kv[st], kt[st]);
      }
#pragma unroll 1
      for (int j = 0; j < ns; ++j) {
        const double c = this->rk_b[j];
        if (c != 0.0) rk_axpy<TANGENT>(T(c) * h, T(c * dh), kv[j], kt[j], xv, xs_t, xtp);
      }
    }
  }

  // the defect c and its transition form dx_{k+1} = F dx_k + G du_k + m
  // ddt + r (the Pallas defect's five values; F = I but for its theta
  // column f02): under the fold E = -I + (dt/2) Jx_e has only a theta
  // column (P, Q), so -E^-1 = [[1, 0, P], [0, 1, Q], [0, 0, 1]]: F's theta
  // column (dt/2) ja + (P, Q), G = -E^-1 dt bu, m = -E^-1 f, r = -E^-1 c;
  // shooting: F, G, m the tangent of Phi, r = c (E = -I)
  __device__ __forceinline__ void linearize(const T xk[NX], const T uk[NU], const T xk1[NX],
                                            T dk, T c[NX], T f02[2], T G[NX][NU], T m[NX],
                                            T r[NX]) const {
    if (this->rule == RULE_SHOOTING) {
      T xv[NX], xs_t[2][4], xt[3];
      shoot<true>(xk, uk, dk, xv, xs_t, xt);
      c[0] = xv[0] - xk1[0];
      c[1] = xv[1] - xk1[1];
      c[2] = wrap(xv[2] - xk1[2]);
      for (int i = 0; i < 2; ++i) {
        f02[i] = xs_t[i][0];
        G[i][0] = xs_t[i][1];
        G[i][1] = xs_t[i][2];
        m[i] = xs_t[i][3];
      }
      G[2][0] = xt[0];
      G[2][1] = xt[1];
      m[2] = xt[2];
      for (int i = 0; i < NX; ++i) r[i] = c[i];
    } else {
      T f[NX], ja[2], je[2], bu[NX][NU];
      fold_dyn(xk, uk, xk1, f, ja, je, bu);
      c[0] = xk[0] + dk * f[0] - xk1[0];
      c[1] = xk[1] + dk * f[1] - xk1[1];
      c[2] = wrap(xk[2] + dk * f[2] - xk1[2]);
      const T hdt = T(0.5) * dk;
      const T pq[2] = {hdt * je[0], hdt * je[1]};
      for (int i = 0; i < 2; ++i) {
        f02[i] = hdt * ja[i] + pq[i];
        for (int j = 0; j < NU; ++j) G[i][j] = dk * bu[i][j] + pq[i] * (dk * bu[2][j]);
        m[i] = f[i] + pq[i] * f[2];
        r[i] = c[i] + pq[i] * c[2];
      }
      for (int j = 0; j < NU; ++j) G[2][j] = dk * bu[2][j];
      m[2] = f[2];
      r[2] = c[2];
    }
  }

  // the defect c = wrap(pred - x_{k+1}): forward differences pred = x_k + dt
  // f(x_k, u_k); midpoint and Crank-Nicolson x_k + dt f of fold_dyn; a
  // shooting grid Phi(x_k, u_k, dt), its value walked as in linearize
  __device__ __forceinline__ void defect_value(const T xk[NX], const T uk[NU],
                                               const T xk1[NX], T dtv, T c[NX]) const {
    if constexpr (COLLOC == COLLOC_OTHER) {
      if (this->rule == RULE_SHOOTING) {
        T xv[NX];
        shoot<false>(xk, uk, dtv, xv, nullptr, nullptr);
        c[0] = xv[0] - xk1[0];
        c[1] = xv[1] - xk1[1];
        c[2] = wrap(xv[2] - xk1[2]);
      } else {
        T f[NX], ja[2], je[2], bu[NX][NU];
        fold_dyn(xk, uk, xk1, f, ja, je, bu);
        c[0] = xk[0] + dtv * f[0] - xk1[0];
        c[1] = xk[1] + dtv * f[1] - xk1[1];
        c[2] = wrap(xk[2] + dtv * f[2] - xk1[2]);
      }
      return;
    }
    T f[NX], jx[2], ju[NX][NU];
    dyn(xk, uk, f, jx, ju);
    c[0] = xk[0] + dtv * f[0] - xk1[0];
    c[1] = xk[1] + dtv * f[1] - xk1[1];
    c[2] = wrap(xk[2] + dtv * f[2] - xk1[2]);
  }

  // the augmented transition of stage k at the current iterate:
  //   Fz = [[F, 0, m], [0, 0, 0], [0, 0, 1]], Gz = [[G], [I], [0]], rz = [c; 0]
  // with F = I + dt Jx, G = dt Ju, m = f (0 on a fixed dt), c the defect
  // (E = -I exactly); on the non-uniform grid (ddt_k the control column 2,
  // ddt_{k-1} in z[5]) Fz = [[F, 0, 0], [0, 0, 0]], Gz = [[G | m], [I3]].
  // The other rules put linearize's F, G, m and r = -E^-1 c in their places.
  __device__ __forceinline__ void transition(int k, T Fz[NA][NA], T Gz[NA][NV],
                                             T rz[NA]) const {
    if constexpr (COLLOC != COLLOC_FD) {
      T xk[NX], uk[NU], xk1[NX], c[NX], f02[2], G[NX][NU], m[NX];
      x_at(k, xk);
      u_at(k, uk);
      x_at(k + 1, xk1);
      linearize(xk, uk, xk1, dt_at(k), c, f02, G, m, rz);
      rz[3] = rz[4] = rz[5] = T(0);
      for (int i = 0; i < NA; ++i)
        for (int j = 0; j < NA; ++j) Fz[i][j] = T(0);
      for (int i = 0; i < NX; ++i) {
        Fz[i][i] = T(1);
        for (int j = 0; j < NU; ++j) Gz[i][j] = G[i][j];
      }
      Fz[0][2] = f02[0];
      Fz[1][2] = f02[1];
      if constexpr (NONU) {
        for (int i = 0; i < NX; ++i) Gz[i][NU] = m[i];
        for (int i = 0; i < NV3; ++i)
          for (int j = 0; j < NV3; ++j) Gz[NX + i][j] = i == j ? T(1) : T(0);
      } else {
        for (int i = 0; i < NX; ++i) Fz[i][NA - 1] = vdt ? m[i] : T(0);
        Fz[NA - 1][NA - 1] = T(1);
        Gz[3][0] = T(1);
        Gz[3][1] = T(0);
        Gz[4][0] = T(0);
        Gz[4][1] = T(1);
        Gz[5][0] = Gz[5][1] = T(0);
      }
      return;
    }
    T xk[NX], uk[NU], xk1[NX], f[NX], jx[2], ju[NX][NU];
    x_at(k, xk);
    u_at(k, uk);
    x_at(k + 1, xk1);
    dyn(xk, uk, f, jx, ju);
    if constexpr (NONU) {
      const T dk = this->dts[k];
      rz[0] = xk[0] + dk * f[0] - xk1[0];
      rz[1] = xk[1] + dk * f[1] - xk1[1];
      rz[2] = wrap(xk[2] + dk * f[2] - xk1[2]);
      rz[3] = rz[4] = rz[5] = T(0);
      for (int i = 0; i < NA; ++i)
        for (int j = 0; j < NA; ++j) Fz[i][j] = T(0);
      for (int i = 0; i < NX; ++i) {
        Fz[i][i] = T(1);
        for (int j = 0; j < NU; ++j) Gz[i][j] = dk * ju[i][j];
        Gz[i][NU] = f[i];
      }
      Fz[0][2] = dk * jx[0];
      Fz[1][2] = dk * jx[1];
      for (int i = 0; i < NV3; ++i)
        for (int j = 0; j < NV3; ++j) Gz[NX + i][j] = i == j ? T(1) : T(0);
      return;
    }
    rz[0] = xk[0] + dt * f[0] - xk1[0];
    rz[1] = xk[1] + dt * f[1] - xk1[1];
    rz[2] = wrap(xk[2] + dt * f[2] - xk1[2]);
    rz[3] = rz[4] = rz[5] = T(0);
    for (int i = 0; i < NA; ++i)
      for (int j = 0; j < NA; ++j) Fz[i][j] = T(0);
    for (int i = 0; i < NX; ++i) {
      Fz[i][i] = T(1);
      Fz[i][NA - 1] = vdt ? f[i] : T(0);
      for (int j = 0; j < NU; ++j) Gz[i][j] = dt * ju[i][j];
    }
    Fz[0][2] = dt * jx[0];
    Fz[1][2] = dt * jx[1];
    Fz[NA - 1][NA - 1] = T(1);
    Gz[3][0] = T(1);
    Gz[3][1] = T(0);
    Gz[4][0] = T(0);
    Gz[4][1] = T(1);
    Gz[5][0] = Gz[5][1] = T(0);
  }

  // ---- obstacle geometry (the Pallas kernel's obs_terms): for disc-family
  // footprints each disc's distance is its center's distance to the slot
  // minus its radius, two discs combine by their minimum with the 0.5 tie
  // split; a segment or a polygon footprint moves with the pose (the
  // Pallas fp_segment / fp_polygon and their distance chains); the
  // gradients are the AD chains of geometry/distances with JAX's
  // subgradients (the segment clip 0.5 at an exact 0 or 1, the minimum of
  // two 0.5 at a tie, an equal split among tied polygon edges, zero under a
  // proper intersection or a containment)

  __device__ __forceinline__ void foot_at(const T x[NX], Foot<T>& D) const {
    if constexpr ((GEO & (GEO_FP_LINE | GEO_FP_POLYGON)) != 0) {
      const T c = cos(x[2]), s = sin(x[2]);
      if constexpr ((GEO & GEO_FP_LINE) != 0) {
        for (int i = 0; i < 2; ++i) {
          const T vx = T(fp_v[i][0]), vy = T(fp_v[i][1]);
          D.px[i] = x[0] + (c * vx - s * vy);
          D.py[i] = x[1] + (s * vx + c * vy);
          D.dpx[i] = -s * vx - c * vy;
          D.dpy[i] = c * vx - s * vy;
        }
      } else {
        D.px[0] = x[0];
        D.py[0] = x[1];
        D.c = c;
        D.s = s;
      }
      return;
    }
    if constexpr (!(GEO & GEO_DISCS)) {
      D.px[0] = x[0];
      D.py[0] = x[1];
      D.dpx[0] = D.dpy[0] = T(0);
      return;
    }
    T c = T(0), s = T(0);
    if (rot) {
      c = cos(x[2]);
      s = sin(x[2]);
    }
    for (int i = 0; i < n_disc; ++i) {
      const T off = disc_off[i];
      if (off == T(0)) {
        D.px[i] = x[0];
        D.py[i] = x[1];
        D.dpx[i] = D.dpy[i] = T(0);
      } else {
        D.px[i] = x[0] + off * c;
        D.py[i] = x[1] + off * s;
        D.dpx[i] = -off * s;
        D.dpy[i] = off * c;
      }
    }
  }

  // point_to_segment from p to [a, b]; with GRAD its gradient in p
  template <bool GRAD>
  __device__ __forceinline__ T point_seg(T px, T py, T ax, T ay, T bx, T by, T& gx,
                                         T& gy) const {
    const T abx = bx - ax, aby = by - ay;
    const T d2 = abx * abx + aby * aby;
    const T denom = d2 < T(EPS) ? T(EPS) : d2;
    const T sx = px - ax, sy = py - ay;
    const T t_raw = (sx * abx + sy * aby) / denom;
    const T t = t_raw < T(0) ? T(0) : (t_raw > T(1) ? T(1) : t_raw);
    const T ex = sx - t * abx, ey = sy - t * aby;
    const T dn = sqrt(ex * ex + ey * ey + T(EPS));
    if (GRAD) {
      const T g1 = t_raw > T(0) ? T(1) : (t_raw == T(0) ? T(0.5) : T(0));
      const T y = t_raw > T(0) ? t_raw : T(0);
      const T g2 = y < T(1) ? T(1) : (y == T(1) ? T(0.5) : T(0));
      const T eab = (ex * abx + ey * aby) * (g1 * g2) / denom;
      gx = (ex - eab * abx) / dn;
      gy = (ey - eab * aby) / dn;
    }
    return dn;
  }

  // whether the slots move (compiled away without GEO_DYNAMIC)
  __device__ __forceinline__ bool moving() const {
    if constexpr ((GEO & GEO_DYNAMIC) != 0) return dynamic;
    return false;
  }

  // ---- the segment and polygon footprints (the Pallas fp_segment,
  // fp_polygon and their distance chains): values and pose gradients g =
  // (d/dx, d/dy, d/dtheta) of the distance

  // jnp.minimum of two (value, pose gradient) candidates, with the 0.5 tie
  // split (the Pallas min2); g may be g1
  template <bool GRAD>
  __device__ __forceinline__ T min2(T d1, const T g1[NX], T d2, const T g2[NX], T g[NX]) const {
    if (GRAD) {
      const T w1 = d1 < d2 ? T(1) : (d1 == d2 ? T(0.5) : T(0));
      const T w2 = d2 < d1 ? T(1) : (d2 == d1 ? T(0.5) : T(0));
      for (int i = 0; i < NX; ++i) g[i] = w1 * g1[i] + w2 * g2[i];
    }
    return vmin(d1, d2);
  }

  // point_to_segment from the fixed point c to the footprint segment S,
  // which moves with the pose; with GRAD its pose gradient, the whole AD
  // chain with the d|ab|^2/dtheta term (the Pallas d_seg_point)
  template <bool GRAD>
  __device__ __forceinline__ T seg_point(const Seg<T>& S, T cx, T cy, T g[NX]) const {
    const T abx = S.bx - S.ax, aby = S.by - S.ay;
    const T d2 = abx * abx + aby * aby;
    const T denom = d2 < T(EPS) ? T(EPS) : d2;
    const T sx = cx - S.ax, sy = cy - S.ay;
    const T t_raw = (sx * abx + sy * aby) / denom;
    const T t = t_raw < T(0) ? T(0) : (t_raw > T(1) ? T(1) : t_raw);
    const T ex = sx - t * abx, ey = sy - t * aby;
    const T dn = sqrt(ex * ex + ey * ey + T(EPS));
    if (GRAD) {
      const T abtx = S.tbx - S.tax, abty = S.tby - S.tay;
      const T gd = d2 > T(EPS) ? T(1) : (d2 == T(EPS) ? T(0.5) : T(0));
      const T ddenom_th = gd * T(2) * (abx * abtx + aby * abty);
      const T ds_th = -(S.tax * abx + S.tay * aby) + (sx * abtx + sy * abty);
      const T g1 = t_raw > T(0) ? T(1) : (t_raw == T(0) ? T(0.5) : T(0));
      const T y = t_raw > T(0) ? t_raw : T(0);
      const T cl = g1 * (y < T(1) ? T(1) : (y == T(1) ? T(0.5) : T(0)));
      const T dt_x = cl * (-abx) / denom, dt_y = cl * (-aby) / denom;
      const T dt_th = cl * (ds_th / denom - t_raw * ddenom_th / denom);
      // e = (c - A) - t ab
      const T dex_x = T(-1) - abx * dt_x, dey_x = -aby * dt_x;
      const T dex_y = -abx * dt_y, dey_y = T(-1) - aby * dt_y;
      const T dex_th = -S.tax - abx * dt_th - t * abtx;
      const T dey_th = -S.tay - aby * dt_th - t * abty;
      g[0] = (ex * dex_x + ey * dey_x) / dn;
      g[1] = (ex * dex_y + ey * dey_y) / dn;
      g[2] = (ex * dex_th + ey * dey_th) / dn;
    }
    return dn;
  }

  // signed area orientation of the triangle (a, b, c)
  __device__ __forceinline__ T orient(T ax, T ay, T bx, T by, T cx, T cy) const {
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
  }

  // segment_to_segment between the footprint segment S and the fixed
  // segment [a, b]: the nested minimum of the four point-segment distances,
  // zero with a zero gradient under a proper intersection. REV: [a, b] is
  // the first argument (segment_to_polygon with the footprint polygon takes
  // the obstacle line first), which pairs the minimum's ties otherwise (the
  // Pallas d_seg_seg and d_seg_seg_rev)
  template <bool GRAD, bool REV>
  __device__ __forceinline__ T seg_seg(const Seg<T>& S, T ax, T ay, T bx, T by, T g[NX]) const {
    T gA[NX], gB[NX], ga[NX], gb[NX], g1[NX], g2[NX];
    T hx = T(0), hy = T(0);
    const T dA = point_seg<GRAD>(S.ax, S.ay, ax, ay, bx, by, hx, hy);
    gA[0] = hx;
    gA[1] = hy;
    gA[2] = hx * S.tax + hy * S.tay;
    const T dB = point_seg<GRAD>(S.bx, S.by, ax, ay, bx, by, hx, hy);
    gB[0] = hx;
    gB[1] = hy;
    gB[2] = hx * S.tbx + hy * S.tby;
    const T da = seg_point<GRAD>(S, ax, ay, ga);
    const T db = seg_point<GRAD>(S, bx, by, gb);
    T d;
    if constexpr (REV) {
      const T d1 = min2<GRAD>(da, ga, db, gb, g1);
      const T d2 = min2<GRAD>(dA, gA, dB, gB, g2);
      d = min2<GRAD>(d1, g1, d2, g2, g);
    } else {
      const T d1 = min2<GRAD>(dA, gA, dB, gB, g1);
      const T d2 = min2<GRAD>(da, ga, db, gb, g2);
      d = min2<GRAD>(d1, g1, d2, g2, g);
    }
    const T o1 = orient(ax, ay, bx, by, S.ax, S.ay), o2 = orient(ax, ay, bx, by, S.bx, S.by);
    const T o3 = orient(S.ax, S.ay, S.bx, S.by, ax, ay), o4 = orient(S.ax, S.ay, S.bx, S.by, bx, by);
    if (o1 * o2 < T(0) && o3 * o4 < T(0)) {
      d = T(0);
      if (GRAD) g[0] = g[1] = g[2] = T(0);
    }
    return d;
  }

  // the even-odd rule's crossing of the edge [a, b] by the ray from p
  // toward +x (point_to_polygon_signed)
  __device__ __forceinline__ bool crosses(T px, T py, T ax, T ay, T bx, T by) const {
    const bool cond = (ay > py) != (by > py);
    const T dy = fabs(by - ay) < T(EPS) ? T(EPS) : by - ay;
    const T x_int = ax + (py - ay) * (bx - ax) / dy;
    return cond && px < x_int;
  }

  // the minimum over polygon edges (jnp.min) with its equal split of the
  // gradient among tied edges: add() each edge, then min() once
  struct EdgeMin {
    T d, g[NX];
    int n;
    __device__ __forceinline__ EdgeMin() : d(T(INFINITY)), n(0) { g[0] = g[1] = g[2] = T(0); }
    template <bool GRAD>
    __device__ __forceinline__ void add(T de, const T ge[NX]) {
      if (de < d || de != de) {
        d = de;
        n = 1;
        if (GRAD)
          for (int i = 0; i < NX; ++i) g[i] = ge[i];
      } else if (de == d) {
        ++n;
        if (GRAD)
          for (int i = 0; i < NX; ++i) g[i] += ge[i];
      }
    }
    // the minimum, and with GRAD its gradient times keep (1, -1 or 0)
    template <bool GRAD>
    __device__ __forceinline__ T min(T keep, T out[NX]) const {
      if (GRAD) {
        const T w = keep / (n > 0 ? T(n) : T(1));
        for (int i = 0; i < NX; ++i) out[i] = w * g[i];
      }
      return keep * d;
    }
  };

  // world vertex v of the footprint polygon at the pose D, and its theta
  // derivative
  __device__ __forceinline__ void fp_vertex(const Foot<T>& D, int v, T& px, T& py, T& tx,
                                            T& ty) const {
    const T vx = T(fp_v[v][0]), vy = T(fp_v[v][1]);
    px = D.px[0] + (D.c * vx - D.s * vy);
    py = D.py[0] + (D.s * vx + D.c * vy);
    tx = -D.s * vx - D.c * vy;
    ty = D.c * vx - D.s * vy;
  }

  // the next edge of the footprint polygon: S's end becomes its start, its
  // end vertex e + 1 (0 after the last); each vertex is formed from the
  // pose's cos and sin where it is needed
  __device__ __forceinline__ void fp_next_edge(const Foot<T>& D, int e, Seg<T>& S) const {
    S.ax = S.bx;
    S.ay = S.by;
    S.tax = S.tbx;
    S.tay = S.tby;
    fp_vertex(D, e + 1 == fp_nv ? 0 : e + 1, S.bx, S.by, S.tbx, S.tby);
  }

  // slot positions at time t: a point or circle slot's center, a line
  // slot's ends, a polygon slot's shift
  __device__ __forceinline__ void circle_at(int j, T t, T& cx, T& cy) const {
    cx = oc[2 * j];
    cy = oc[2 * j + 1];
    if (moving()) {
      cx = cx + ovel[2 * j] * t;
      cy = cy + ovel[2 * j + 1] * t;
    }
  }
  __device__ __forceinline__ void line_at(int l, T t, T& ax, T& ay, T& bx, T& by) const {
    const T* e = ln + 4 * l;
    T shx = T(0), shy = T(0);
    if (moving()) {
      shx = lvel[2 * l] * t;
      shy = lvel[2 * l + 1] * t;
    }
    ax = e[0] + shx;
    ay = e[1] + shy;
    bx = e[2] + shx;
    by = e[3] + shy;
  }
  __device__ __forceinline__ void polygon_shift(int g, T t, T& shx, T& shy) const {
    shx = shy = T(0);
    if (moving()) {
      shx = pvel[2 * g] * t;
      shy = pvel[2 * g + 1] * t;
    }
  }

  // the footprint segment to slot j at time t (BIG on a masked slot): a
  // point or circle slot by point_to_segment from its center less its
  // radius, a line slot by segment_to_segment, a polygon slot by
  // segment_to_polygon (zero when the segment's start lies inside); with
  // GRAD the pose gradient g (the Pallas d_seg_point, d_seg_seg,
  // d_seg_polygon)
  template <bool GRAD>
  __device__ __forceinline__ T fp_line_dist(const Foot<T>& D, int j, T t, T g[NX]) const {
    const Seg<T> S = {D.px[0], D.py[0], D.px[1], D.py[1], D.dpx[0], D.dpy[0], D.dpx[1], D.dpy[1]};
    if constexpr ((GEO & GEO_LINES) != 0) {
      if (j >= Mc && j < Mc + Ml) {
        const int l = j - Mc;
        T ax, ay, bx, by;
        line_at(l, t, ax, ay, bx, by);
        const T d = seg_seg<GRAD, false>(S, ax, ay, bx, by, g);
        return lmask[l] ? d : T(BIG);
      }
    }
    if constexpr ((GEO & GEO_POLYGONS) != 0) {
      if (j >= Mc + Ml) {
        const int q = j - Mc - Ml;
        const T* vx = pg + 2 * V * q;
        int nv = pnv[q];
        nv = nv < V ? nv : V;
        T shx, shy;
        polygon_shift(q, t, shx, shy);
        EdgeMin acc;
        int crossings = 0;
        for (int v = 0; v < nv; ++v) {
          const int w = v + 1 == nv ? 0 : v + 1;
          const T ax = vx[2 * v] + shx, ay = vx[2 * v + 1] + shy;
          const T bx = vx[2 * w] + shx, by = vx[2 * w + 1] + shy;
          T ge[NX];
          acc.template add<GRAD>(seg_seg<GRAD, false>(S, ax, ay, bx, by, ge), ge);
          if (crosses(S.ax, S.ay, ax, ay, bx, by)) ++crossings;
        }
        const T d = acc.template min<GRAD>((crossings & 1) ? T(0) : T(1), g);
        return pmask[q] ? d : T(BIG);
      }
    }
    T cx, cy;
    circle_at(j, t, cx, cy);
    const T dn = seg_point<GRAD>(S, cx, cy, g);
    return omask[j] ? dn - orad[j] : T(BIG);
  }

  // the footprint polygon to slot j at time t (BIG on a masked slot): a
  // point or circle slot by the signed distance of its center (negative
  // inside the footprint, by the even-odd rule) less its radius, a line
  // slot by segment_to_polygon with the line first (zero when its first
  // end lies inside), a polygon slot by polygon_to_polygon with the
  // footprint first: every pair of a footprint edge and an active slot
  // edge, looped, zero when either polygon holds the other's first vertex;
  // with GRAD the pose gradient g (the Pallas d_point_fp_polygon,
  // d_seg_fp_polygon, d_polygon_fp_polygon)
  template <bool GRAD>
  __device__ __forceinline__ T fp_polygon_dist(const Foot<T>& D, int j, T t, T g[NX]) const {
    EdgeMin acc;
    int crossings = 0;
    Seg<T> S;
    fp_vertex(D, 0, S.bx, S.by, S.tbx, S.tby);
    if constexpr ((GEO & GEO_LINES) != 0) {
      if (j >= Mc && j < Mc + Ml) {
        const int l = j - Mc;
        T ax, ay, bx, by;
        line_at(l, t, ax, ay, bx, by);
#pragma unroll 1
        for (int e = 0; e < fp_nv; ++e) {
          fp_next_edge(D, e, S);
          T ge[NX];
          acc.template add<GRAD>(seg_seg<GRAD, true>(S, ax, ay, bx, by, ge), ge);
          if (crosses(ax, ay, S.ax, S.ay, S.bx, S.by)) ++crossings;
        }
        const T d = acc.template min<GRAD>((crossings & 1) ? T(0) : T(1), g);
        return lmask[l] ? d : T(BIG);
      }
    }
    if constexpr ((GEO & GEO_POLYGONS) != 0) {
      if (j >= Mc + Ml) {
        const int q = j - Mc - Ml;
        const T* vx = pg + 2 * V * q;
        int nv = pnv[q];
        nv = nv < V ? nv : V;
        T shx, shy;
        polygon_shift(q, t, shx, shy);
        const T v0x = vx[0] + shx, v0y = vx[1] + shy;
        const T f0x = S.bx, f0y = S.by;  // the footprint's vertex 0
        int in_fp = 0, in_slot = 0;
#pragma unroll 1
        for (int e = 0; e < fp_nv; ++e) {
          fp_next_edge(D, e, S);
          if (crosses(v0x, v0y, S.ax, S.ay, S.bx, S.by)) ++in_fp;
#pragma unroll 1
          for (int v = 0; v < nv; ++v) {
            const int w = v + 1 == nv ? 0 : v + 1;
            const T ax = vx[2 * v] + shx, ay = vx[2 * v + 1] + shy;
            const T bx = vx[2 * w] + shx, by = vx[2 * w + 1] + shy;
            T ge[NX];
            acc.template add<GRAD>(seg_seg<GRAD, false>(S, ax, ay, bx, by, ge), ge);
            if (e == 0 && crosses(f0x, f0y, ax, ay, bx, by)) ++in_slot;
          }
        }
        const bool overlap = (in_slot & 1) || (in_fp & 1);
        const T d = acc.template min<GRAD>(overlap ? T(0) : T(1), g);
        return pmask[q] ? d : T(BIG);
      }
    }
    T cx, cy;
    circle_at(j, t, cx, cy);
#pragma unroll 1
    for (int e = 0; e < fp_nv; ++e) {
      fp_next_edge(D, e, S);
      T ge[NX];
      acc.template add<GRAD>(seg_point<GRAD>(S, cx, cy, ge), ge);
      if (crosses(cx, cy, S.ax, S.ay, S.bx, S.by)) ++crossings;
    }
    const T d = acc.template min<GRAD>((crossings & 1) ? T(-1) : T(1), g);
    return omask[j] ? d - orad[j] : T(BIG);
  }

  // the distance from the disc center p to slot j at time t (BIG on a
  // masked slot) before the disc's radius, and with GRAD its gradient in p
  template <bool GRAD>
  __device__ __forceinline__ T slot_dist(int j, T px, T py, T t, T& gx, T& gy) const {
    if constexpr ((GEO & GEO_LINES) != 0) {
      if (j >= Mc && j < Mc + Ml) return line_dist<GRAD>(j - Mc, px, py, t, gx, gy);
    }
    if constexpr ((GEO & GEO_POLYGONS) != 0) {
      if (j >= Mc + Ml) return polygon_dist<GRAD>(j - Mc - Ml, px, py, t, gx, gy);
    }
    T cx = oc[2 * j], cy = oc[2 * j + 1];
    if (moving()) {
      cx = cx + ovel[2 * j] * t;
      cy = cy + ovel[2 * j + 1] * t;
    }
    const T ex = px - cx, ey = py - cy;
    const T dn = sqrt(ex * ex + ey * ey + T(EPS));
    if (GRAD) {
      gx = ex / dn;
      gy = ey / dn;
    }
    return omask[j] ? dn - orad[j] : T(BIG);
  }

  // line slot l: point_to_segment from p to its moved endpoints
  template <bool GRAD>
  __device__ __forceinline__ T line_dist(int l, T px, T py, T t, T& gx, T& gy) const {
    const T* e = ln + 4 * l;
    T shx = T(0), shy = T(0);
    if (moving()) {
      shx = lvel[2 * l] * t;
      shy = lvel[2 * l + 1] * t;
    }
    const T dn = point_seg<GRAD>(px, py, e[0] + shx, e[1] + shy, e[2] + shx, e[3] + shy, gx, gy);
    return lmask[l] ? dn : T(BIG);
  }

  // polygon slot g: point_to_polygon_signed, the minimum over the active
  // edges (edge v runs from vertex v to vertex v + 1, or 0 after the last),
  // negated inside by the even-odd crossing count
  template <bool GRAD>
  __device__ __forceinline__ T polygon_dist(int g, T px, T py, T t, T& gx, T& gy) const {
    const T* vx = pg + 2 * V * g;
    int nv = pnv[g];
    nv = nv < V ? nv : V;
    T shx = T(0), shy = T(0);
    if (moving()) {
      shx = pvel[2 * g] * t;
      shy = pvel[2 * g + 1] * t;
    }
    T dmin = T(INFINITY), sgx = T(0), sgy = T(0);
    int cnt = 0, crossings = 0;
    for (int v = 0; v < nv; ++v) {
      const int w = v + 1 == nv ? 0 : v + 1;
      const T ax = vx[2 * v] + shx, ay = vx[2 * v + 1] + shy;
      const T bx = vx[2 * w] + shx, by = vx[2 * w + 1] + shy;
      T ex, ey;
      const T d = point_seg<GRAD>(px, py, ax, ay, bx, by, ex, ey);
      if (d < dmin || d != d) {
        dmin = d;
        sgx = ex;
        sgy = ey;
        cnt = 1;
      } else if (d == dmin) {
        sgx += ex;
        sgy += ey;
        ++cnt;
      }
      const bool cond = (ay > py) != (by > py);
      const T dy = fabs(by - ay) < T(EPS) ? T(EPS) : by - ay;
      const T x_int = ax + (py - ay) * (bx - ax) / dy;
      if (cond && px < x_int) ++crossings;
    }
    const T sgn = (crossings & 1) ? T(-1) : T(1);
    if (GRAD) {
      const T n = cnt > 0 ? T(cnt) : T(1);
      gx = sgn * (sgx / n);
      gy = sgn * (sgy / n);
    }
    return pmask[g] ? sgn * dmin : T(BIG);
  }

  // obstacle row j at the discs D, time t: g = min_dist - d and with GRAD
  // its pose gradient g3 = (dg/dx, dg/dy, dg/dtheta)
  template <bool GRAD>
  __device__ __forceinline__ T obs_row(const Foot<T>& D, int j, T t, T g3[NX]) const {
    if constexpr ((GEO & (GEO_FP_LINE | GEO_FP_POLYGON)) != 0) {
      T g[NX] = {T(0), T(0), T(0)};
      T d;
      if constexpr ((GEO & GEO_FP_LINE) != 0)
        d = fp_line_dist<GRAD>(D, j, t, g);
      else
        d = fp_polygon_dist<GRAD>(D, j, t, g);
      if (GRAD)
        for (int i = 0; i < NX; ++i) g3[i] = -g[i];
      return min_dist - d;
    } else {
      T gx = T(0), gy = T(0);
      T d = slot_dist<GRAD>(j, D.px[0], D.py[0], t, gx, gy) - disc_r[0];
      T gth = GRAD ? gx * D.dpx[0] + gy * D.dpy[0] : T(0);
      if ((GEO & GEO_DISCS) != 0 && n_disc == 2) {
        T hx = T(0), hy = T(0);
        const T d2 = slot_dist<GRAD>(j, D.px[1], D.py[1], t, hx, hy) - disc_r[1];
        if (GRAD) {
          const T hth = hx * D.dpx[1] + hy * D.dpy[1];
          const T w1 = d < d2 ? T(1) : (d == d2 ? T(0.5) : T(0));
          const T w2 = d2 < d ? T(1) : (d2 == d ? T(0.5) : T(0));
          gx = w1 * gx + w2 * hx;
          gy = w1 * gy + w2 * hy;
          gth = w1 * gth + w2 * hth;
        }
        d = vmin(d, d2);
      }
      if (GRAD) {
        g3[0] = -gx;
        g3[1] = -gy;
        g3[2] = -gth;
      }
      return min_dist - d;
    }
  }

  // the obstacle rows' AL gradient and crisp Gauss-Newton block on the pose
  // at x with multiplier row mu_row, time t: a = max(0, mu + rho g),
  // aw = rho [mu + rho g > 0]
  __device__ __forceinline__ void obstacle_block(const T x[NX], const T* mu_row, T t, T h[NA],
                                                 T H[NA][NA]) const {
    Foot<T> D;
    foot_at(x, D);
    for (int j = 0; j < M; ++j) {
      T g3[NX];
      const T g = obs_row<true>(D, j, t, g3);
      const T tt = mu_row[j] + rho * g;
      const T a = hinge(tt);
      const T aw = tt > T(0) ? rho : T(0);
      for (int r = 0; r < NX; ++r) {
        h[r] += a * g3[r];
        for (int c = r; c < NX; ++c) H[r][c] += aw * g3[r] * g3[c];
      }
    }
    H[1][0] = H[0][1];
    H[2][0] = H[0][2];
    H[2][1] = H[1][2];
  }

  // the prediction time of pose i at dt (0 for static slots)
  __device__ __forceinline__ T pose_time(int i, T dtv) const {
    return moving() ? T(i) * dtv : T(0);
  }

  // the prediction time of pose i in the derivatives: at the solve's initial
  // dt, on the non-uniform grid the hoisted sum of its initial stage dt
  __device__ __forceinline__ T deriv_time(int i) const {
    if constexpr (NONU) return moving() ? tv(i) : T(0);
    return pose_time(i, dt0);
  }

  // rows of the stage inequalities that are linear: rate (4) and box (4)
  __device__ __forceinline__ void rate_g(const T u[NU], const T up[NU], T dtv, T g[4]) const {
    const T du0 = u[0] - up[0], du1 = u[1] - up[1];
    g[0] = du0 - hi_r[0] * dtv;
    g[1] = du1 - hi_r[1] * dtv;
    g[2] = lo_r[0] * dtv - du0;
    g[3] = lo_r[1] * dtv - du1;
  }
  __device__ __forceinline__ void box_g(const T u[NU], T g[4]) const {
    g[0] = u[0] - hi_u[0];
    g[1] = u[1] - hi_u[1];
    g[2] = lo_u[0] - u[0];
    g[3] = lo_u[1] - u[1];
  }

  // the quadratic form's stage terms on the non-uniform grid, exact: the dt
  // terms on the control column 2, the trapezoidal dt_{k-1} coupling on
  // z[5] (the Pallas nonu branch of stage_grad_hess)
  __device__ __forceinline__ void quadratic_nonu(int k, const T xk[NX], const T uk[NU],
                                                 T hz[NA], T hu[NV], T Hzz[NA][NA],
                                                 T Hzu[NA][NV], T Huu[NV][NV]) const {
    T d[NX];
    goal_dx(xk, d);
    const T dk = this->dts[k];
    if (integral) {
      const T lx = q[0] * d[0] * d[0] + q[1] * d[1] * d[1] + q[2] * d[2] * d[2];
      const T lu = r[0] * uk[0] * uk[0] + r[1] * uk[1] * uk[1];
      const T dtp = k == 0 ? T(0) : this->dts[k - 1];
      const T wx = trapezoidal ? T(0.5) * (dtp + dk) : dk;
      if (trapezoidal) {
        hz[5] += T(0.5) * lx;
        hu[2] += T(0.5) * lx + lu;
      } else {
        hu[2] += lx + lu;
      }
      for (int i = 0; i < NX; ++i) {
        const T qi = T(2) * q[i] * d[i];
        hz[i] += qi * wx;
        Hzz[i][i] += T(2) * q[i] * wx;
        if (trapezoidal) {
          Hzz[i][5] += T(0.5) * qi;
          Hzz[5][i] = Hzz[i][5];
          Hzu[i][2] += T(0.5) * qi;
        } else {
          Hzu[i][2] += qi;
        }
      }
      for (int j = 0; j < NU; ++j) {
        const T rj = T(2) * r[j] * uk[j];
        hu[j] += rj * dk;
        Huu[j][j] += T(2) * r[j] * dk;
        Huu[j][2] += rj;
        Huu[2][j] = Huu[j][2];
      }
    } else {
      for (int i = 0; i < NX; ++i) {
        hz[i] += T(2) * q[i] * d[i];
        Hzz[i][i] += T(2) * q[i];
      }
      for (int j = 0; j < NU; ++j) {
        hu[j] += T(2) * r[j] * uk[j];
        Huu[j][j] += T(2) * r[j];
      }
    }
    if (hybrid > T(0)) hu[2] += hybrid;
  }

  // exact AL gradient (hz, hu) and hybrid Gauss-Newton Hessian blocks of the
  // stage-k merit over z = [x, u_prev, dt] and v = u; on the non-uniform grid
  // over z = [x, u_prev, dt_{k-1}] and v = [u, dt_k], with the interval's dt
  // box and the ddt column's proximal weight
  __device__ __forceinline__ void stage_grad_hess(int k, T hz[NA], T hu[NV], T Hzz[NA][NA],
                                                  T Hzu[NA][NV], T Huu[NV][NV]) const {
    for (int i = 0; i < NA; ++i) {
      hz[i] = T(0);
      for (int j = 0; j < NA; ++j) Hzz[i][j] = T(0);
      for (int j = 0; j < NV; ++j) Hzu[i][j] = T(0);
    }
    for (int i = 0; i < NV; ++i) {
      hu[i] = T(0);
      for (int j = 0; j < NV; ++j) Huu[i][j] = T(0);
    }
    T xk[NX], uk[NU], up[NU];
    x_at(k, xk);
    u_at(k, uk);
    uprev_at(k, up);
    if constexpr (QUAD && NONU) {
      quadratic_nonu(k, xk, uk, hz, hu, Hzz, Hzu, Huu);
    } else if constexpr (QUAD) {
      // the quadratic form, exact: gradient and (diagonal, PSD) Hessian,
      // with the x-dt and u-dt rows of the integral form
      T d[NX];
      goal_dx(xk, d);
      if (integral) {
        const T iw = (trapezoidal && k == 0) ? T(0.5) : T(1);
        const T lx = q[0] * d[0] * d[0] + q[1] * d[1] * d[1] + q[2] * d[2] * d[2];
        const T lu = r[0] * uk[0] * uk[0] + r[1] * uk[1] * uk[1];
        hz[5] += iw * lx + lu;
        for (int i = 0; i < NX; ++i) {
          const T qi = T(2) * q[i] * iw * d[i];
          hz[i] += qi * dt;
          Hzz[i][i] += T(2) * q[i] * iw * dt;
          Hzz[i][5] += qi;
          Hzz[5][i] = Hzz[i][5];
        }
        for (int j = 0; j < NU; ++j) {
          const T rj = T(2) * r[j] * uk[j];
          hu[j] += rj * dt;
          Huu[j][j] += T(2) * r[j] * dt;
          Hzu[5][j] += rj;
        }
      } else {
        for (int i = 0; i < NX; ++i) {
          hz[i] += T(2) * q[i] * d[i];
          Hzz[i][i] += T(2) * q[i];
        }
        for (int j = 0; j < NU; ++j) {
          hu[j] += T(2) * r[j] * uk[j];
          Huu[j][j] += T(2) * r[j];
        }
      }
      if (hybrid > T(0)) hz[5] += hybrid;
    } else {
      // minimum time: the stage cost dt has a unit gradient (dt_k: v[2])
      if constexpr (NONU)
        hu[2] = T(1);
      else
        hz[5] = T(1);
      if constexpr (VIA) via_rows(xk, k, hz, Hzz);
    }

    // obstacles at x_k with multiplier row k-1 (inactive at k = 0), predicted
    // to k dt at the solve's initial dt
    if (k > 0) obstacle_block(xk, mo + (k - 1) * M, deriv_time(k), hz, Hzz);

    // rate rows g = +-(du - b dt): J over [u_prev (z), dt (z), u (v)]; on the
    // non-uniform grid dt_k is v[2]
    T gr[4];
    rate_g(uk, up, dt_at(k), gr);
    for (int idx = 0; idx < 4; ++idx) {
      const int comp = idx & 1;
      const T sgn = idx < 2 ? T(1) : T(-1);
      const T bnd = idx < 2 ? hi_r[comp] : lo_r[comp];
      const T t = mr[k * 4 + idx] + rho * gr[idx];
      const T a = hinge(t);
      const T aw = hinge_w(t, rho);
      const T jz_up = -sgn, jz_t = -sgn * bnd, jv = sgn;
      const int zi = 3 + comp;
      hz[zi] += a * jz_up;
      hu[comp] += a * jv;
      Hzz[zi][zi] += aw * jz_up * jz_up;
      Hzu[zi][comp] += aw * jz_up * jv;
      Huu[comp][comp] += aw * jv * jv;
      if constexpr (NONU) {
        hu[2] += a * jz_t;
        Hzu[zi][2] += aw * jz_up * jz_t;
        Huu[comp][2] += aw * jv * jz_t;
        Huu[2][comp] = Huu[comp][2];
        Huu[2][2] += aw * jz_t * jz_t;
        continue;
      }
      hz[5] += a * jz_t;
      Hzz[zi][5] += aw * jz_up * jz_t;
      Hzz[5][zi] = Hzz[zi][5];
      Hzz[5][5] += aw * jz_t * jz_t;
      Hzu[5][comp] += aw * jz_t * jv;
    }

    // box rows g = +-(u - b): J over u only
    T gb[4];
    box_g(uk, gb);
    for (int idx = 0; idx < 4; ++idx) {
      const int comp = idx & 1;
      const T sgn = idx < 2 ? T(1) : T(-1);
      const T t = mb[k * 4 + idx] + rho * gb[idx];
      hu[comp] += hinge(t) * sgn;
      Huu[comp][comp] += hinge_w(t, rho);
    }

    if constexpr (NONU) {
      // the interval's dt box, exact, and the ddt column's proximal weight
      const T dk = this->dts[k];
      const T t1 = md[2 * k] + rho * (dk - dt_max);
      const T t2 = md[2 * k + 1] + rho * (dt_min - dk);
      hu[2] += hinge(t1) - hinge(t2);
      Huu[2][2] += hinge_w(t1, rho) + hinge_w(t2, rho);
      if (this->dt_prox > T(0)) Huu[2][2] += this->dt_prox;
    }
  }

  // PN (6x6) and pN (6) of the terminal merit: the masked terminal equality,
  // Qf, the obstacle Gauss-Newton block at x_N (multiplier row N-1), the
  // trapezoidal tail, the terminal ball and the dt box (variable uniform dt
  // only; on the non-uniform grid z[5] is dt_{N-1} and the boxes are stage
  // rows)
  __device__ __forceinline__ void terminal_Pp(T P[NA][NA], T p[NA]) const {
    for (int i = 0; i < NA; ++i) {
      p[i] = T(0);
      for (int j = 0; j < NA; ++j) P[i][j] = T(0);
    }
    T xN[NX];
    x_at(N, xN);
    const T gd[NX] = {xN[0] - xf[0], xN[1] - xf[1], wrap(xN[2] - xf[2])};
    for (int i = 0; i < NX; ++i) {
      if (fixed[i]) {
        P[i][i] += rho;
        p[i] += lt[i] + rho * gd[i];
      }
    }
    if (has_qf) {
      for (int i = 0; i < NX; ++i) {
        P[i][i] += T(2) * qf[i];
        p[i] += T(2) * qf[i] * gd[i];
      }
    }
    if constexpr (VIA) via_rows(xN, N, p, P);
    obstacle_block(xN, mo + (N - 1) * M, deriv_time(N), p, P);
    if (QUAD && integral && trapezoidal) {
      // the 1/2 dt lx(x_N) tail, exact, with its dtau cross terms
      const T dtN = dt_at(N - 1);
      p[5] += T(0.5) * (q[0] * gd[0] * gd[0] + q[1] * gd[1] * gd[1] + q[2] * gd[2] * gd[2]);
      for (int i = 0; i < NX; ++i) {
        p[i] += q[i] * gd[i] * dtN;
        P[i][i] += q[i] * dtN;
        P[i][5] += q[i] * gd[i];
        P[5][i] = P[i][5];
      }
    }
    if (ball_on) {
      // exact PSD Hessian of the PHR ball penalty: rho s^2 g' g'^T (s the tie
      // subgradient, see hinge_w) + a * 2 diag(w)
      T gp[NX];
      const T tb = mball[0] + rho * ball_g(xN, gp);
      const T ab = hinge(tb), hwb = hinge_w(tb, rho);
      for (int i = 0; i < NX; ++i) {
        p[i] += ab * gp[i];
        P[i][i] += T(2) * ball_w[i] * ab;
        for (int j = 0; j < NX; ++j) P[i][j] += hwb * gp[i] * gp[j];
      }
    }
    if (vdt && !NONU) {
      const T t1 = md[0] + rho * (dt - dt_max);
      const T t2 = md[1] + rho * (dt_min - dt);
      p[5] += hinge(t1) - hinge(t2);
      P[5][5] += hinge_w(t1, rho) + hinge_w(t2, rho);
    }
  }

  // ---- the team: TEAM lanes of one warp solve the scenario together ------ //

  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  // sums, maxima and minima over the team, the same on every lane (a
  // butterfly: both lanes of a pair form a + b, which is b + a); vmax and
  // vmin keep a NaN
  __device__ __forceinline__ T team_sum(T v) const {
#pragma unroll
    for (int o = TEAM / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
    return v;
  }
  __device__ __forceinline__ T team_vmax(T v) const {
#pragma unroll
    for (int o = TEAM / 2; o > 0; o >>= 1) v = vmax(v, __shfl_xor_sync(mask, v, o));
    return v;
  }
  __device__ __forceinline__ T team_vmin(T v) const {
#pragma unroll
    for (int o = TEAM / 2; o > 0; o >>= 1) v = vmin(v, __shfl_xor_sync(mask, v, o));
    return v;
  }
  __device__ __forceinline__ bool team_any(bool p) const { return __any_sync(mask, p) != 0; }

  // stage k's terms into the chunk slot s: the transition (Fz, Gz, rz) and
  // the stage's AL gradient and Hessian blocks, laid out as O_FZ .. O_HU
  __device__ __forceinline__ void stage_transition(int k, T* s) const {
    T Fz[NA][NA], Gz[NA][NV], rz[NA];
    transition(k, Fz, Gz, rz);
    for (int i = 0; i < NA; ++i) {
      for (int j = 0; j < NA; ++j) s[O_FZ + i * NA + j] = Fz[i][j];
      for (int j = 0; j < NV; ++j) s[O_GZ + i * NV + j] = Gz[i][j];
      s[O_RZ + i] = rz[i];
    }
  }
  __device__ __forceinline__ void stage_terms(int k, T* s) const {
    stage_transition(k, s);
    T hz[NA], hu[NV], Hzz[NA][NA], Hzu[NA][NV], Huu[NV][NV];
    stage_grad_hess(k, hz, hu, Hzz, Hzu, Huu);
    for (int i = 0; i < NA; ++i) {
      for (int j = 0; j < NA; ++j) s[O_HZZ + i * NA + j] = Hzz[i][j];
      for (int j = 0; j < NV; ++j) s[O_HZU + i * NV + j] = Hzu[i][j];
      s[O_HZ + i] = hz[i];
    }
    for (int i = 0; i < NV; ++i) {
      for (int j = 0; j < NV; ++j) s[O_HUU + i * NV + j] = Huu[i][j];
      s[O_HU + i] = hu[i];
    }
  }

  // Quu^-1 from the scratch: the closed-form 2x2 inverse, or on the
  // non-uniform grid the 3x3 adjugate over the determinant (the Pallas
  // kernel's cofactor order); every lane forms the same
  __device__ __forceinline__ void quu_inverse(T Qi[NV][NV]) const {
    const T* Q = sc + S_QUU;
    if constexpr (NONU) {
      const T a00 = Q[0], a01 = Q[1], a02 = Q[2];
      const T a10 = Q[3], a11 = Q[4], a12 = Q[5];
      const T a20 = Q[6], a21 = Q[7], a22 = Q[8];
      const T c00 = a11 * a22 - a12 * a21, c01 = a02 * a21 - a01 * a22, c02 = a01 * a12 - a02 * a11;
      const T c10 = a12 * a20 - a10 * a22, c11 = a00 * a22 - a02 * a20, c12 = a02 * a10 - a00 * a12;
      const T c20 = a10 * a21 - a11 * a20, c21 = a01 * a20 - a00 * a21, c22 = a00 * a11 - a01 * a10;
      const T inv_det = T(1) / (a00 * c00 + a01 * c10 + a02 * c20);
      const T c[3][3] = {{c00, c01, c02}, {c10, c11, c12}, {c20, c21, c22}};
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) Qi[i][j] = c[i][j] * inv_det;
    } else {
      const T inv_det = T(1) / (Q[0] * Q[3] - Q[1] * Q[2]);
      Qi[0][0] = Q[3] * inv_det;
      Qi[0][1] = -Q[1] * inv_det;
      Qi[1][0] = -Q[2] * inv_det;
      Qi[1][1] = Q[0] * inv_det;
    }
  }
  // K[r][j] = -(Quu^-1 Qzu')[r][j] and kff[r] = -(Quu^-1 qu)[r]
  __device__ __forceinline__ T gain_K(const T Qi[NV][NV], int r, int j) const {
    const T* Qzu = sc + S_QZU;
    T acc = Qi[r][0] * Qzu[j * NV] + Qi[r][1] * Qzu[j * NV + 1];
    if constexpr (NONU) acc = acc + Qi[r][2] * Qzu[j * NV + 2];
    return -acc;
  }
  __device__ __forceinline__ T gain_k(const T Qi[NV][NV], int r) const {
    const T* qu = sc + S_QU;
    T acc = Qi[r][0] * qu[0] + Qi[r][1] * qu[1];
    if constexpr (NONU) acc = acc + Qi[r][2] * qu[2];
    return -acc;
  }

  // one stage of the backward Riccati recursion on the stage terms in s,
  // cooperative: each of three phases spreads its entries over the lanes,
  // each entry a dot product of length 6 over the scratch (P, p and the
  // products in shared memory), each phase ended by a team barrier
  //   A: PF = P Fz, PG = P Gz, Prp = P rz + p
  //   B: Qzz = Hzz + Fz' PF, Qzu = Hzu + Fz' PG, qz = hz + Fz' Prp,
  //      Quu = Huu + Gz' PG + reg I, qu = hu + Gz' Prp
  //   C: K = -Quu^-1 Qzu', kff = -Quu^-1 qu into the tape; P <- Qzz + Qzu K
  //      (symmetrized), p <- qz + Qzu kff
  __device__ __forceinline__ void riccati_stage(int k, const T* s, T reg) {
    const T* Fz = s + O_FZ;
    const T* Gz = s + O_GZ;
    const T* rz = s + O_RZ;
    T* P = sc + S_P;
    T* p = sc + S_PV;
    T* PF = sc + S_PF;
    T* PG = sc + S_PG;
    T* Prp = sc + S_PRP;
    T* Qzz = sc + S_QZZ;
    T* Qzu = sc + S_QZU;
    T* qz = sc + S_QZ;
    T* Quu = sc + S_QUU;
    T* qu = sc + S_QU;
    constexpr int NA_A = NA * NA + NA * NV + NA;
    for (int w = lane; w < NA_A; w += TEAM) {
      T acc = T(0);
      if (w < NA * NA) {
        const int i = w / NA, j = w % NA;
#pragma unroll
        for (int l = 0; l < NA; ++l) acc += P[i * NA + l] * Fz[l * NA + j];
        PF[w] = acc;
      } else if (w < NA * NA + NA * NV) {
        const int e = w - NA * NA, i = e / NV, j = e % NV;
#pragma unroll
        for (int l = 0; l < NA; ++l) acc += P[i * NA + l] * Gz[l * NV + j];
        PG[e] = acc;
      } else {
        const int i = w - NA * NA - NA * NV;
#pragma unroll
        for (int l = 0; l < NA; ++l) acc += P[i * NA + l] * rz[l];
        Prp[i] = acc + p[i];
      }
    }
    sync();
    constexpr int NB_Z = NA * NA + NA * NV + NA, NB_A = NB_Z + NV * NV + NV;
    for (int w = lane; w < NB_A; w += TEAM) {
      T acc = T(0);
      if (w < NA * NA) {
        const int i = w / NA, j = w % NA;
#pragma unroll
        for (int l = 0; l < NA; ++l) acc += Fz[l * NA + i] * PF[l * NA + j];
        Qzz[w] = s[O_HZZ + w] + acc;
      } else if (w < NA * NA + NA * NV) {
        const int e = w - NA * NA, i = e / NV, j = e % NV;
#pragma unroll
        for (int l = 0; l < NA; ++l) acc += Fz[l * NA + i] * PG[l * NV + j];
        Qzu[e] = s[O_HZU + e] + acc;
      } else if (w < NB_Z) {
        const int i = w - NA * NA - NA * NV;
#pragma unroll
        for (int l = 0; l < NA; ++l) acc += Fz[l * NA + i] * Prp[l];
        qz[i] = s[O_HZ + i] + acc;
      } else if (w < NB_Z + NV * NV) {
        const int e = w - NB_Z, i = e / NV, j = e % NV;
#pragma unroll
        for (int l = 0; l < NA; ++l) acc += Gz[l * NV + i] * PG[l * NV + j];
        Quu[e] = s[O_HUU + e] + acc + (i == j ? reg : T(0));
      } else {
        const int i = w - NB_Z - NV * NV;
#pragma unroll
        for (int l = 0; l < NA; ++l) acc += Gz[l * NV + i] * Prp[l];
        qu[i] = s[O_HU + i] + acc;
      }
    }
    sync();
    T Qi[NV][NV];
    quu_inverse(Qi);
    constexpr int NC_P = NA * NA + NA, NC_A = NC_P + NV * NA + NV;
    for (int w = lane; w < NC_A; w += TEAM) {
      if (w < NA * NA) {
        const int i = w / NA, j = w % NA;
        T ki[NV], kj[NV];
#pragma unroll
        for (int r = 0; r < NV; ++r) {
          kj[r] = gain_K(Qi, r, j);
          ki[r] = gain_K(Qi, r, i);
        }
        T sv = Qzu[i * NV] * kj[0] + Qzu[i * NV + 1] * kj[1];
        T sT = Qzu[j * NV] * ki[0] + Qzu[j * NV + 1] * ki[1];
        if constexpr (NONU) {
          sv = sv + Qzu[i * NV + 2] * kj[2];
          sT = sT + Qzu[j * NV + 2] * ki[2];
        }
        const T v = Qzz[i * NA + j] + sv;
        const T vT = Qzz[j * NA + i] + sT;
        P[w] = T(0.5) * (v + vT);
      } else if (w < NC_P) {
        const int i = w - NA * NA;
        T sv = Qzu[i * NV] * gain_k(Qi, 0) + Qzu[i * NV + 1] * gain_k(Qi, 1);
        if constexpr (NONU) sv = sv + Qzu[i * NV + 2] * gain_k(Qi, 2);
        p[i] = qz[i] + sv;
      } else if (w < NC_P + NV * NA) {
        const int e = w - NC_P, r = e / NA, j = e % NA;
        Kt(k, r, j) = gain_K(Qi, r, j);
      } else {
        const int r = w - NC_P - NV * NA;
        kft(k, r) = gain_k(Qi, r);
      }
    }
    sync();
  }

  // the step of one SQP iteration into dxs, dus, dtau (the algebra of kernel
  // K1; on the non-uniform grid the control is [du, ddt_k], ddt_k into dtaus,
  // and no free dtau). The backward sweep walks chunks of TEAM items from the
  // last: item k < N is stage k's terms, computed by lane k % TEAM into its
  // chunk slot, item N the terminal P, p; then the recursion runs over the
  // chunk's stages. The rollout walks the chunks forward: the lanes form the
  // chunk's transitions, then lanes 0-5 each carry one row of z.
  __device__ __forceinline__ void kkt_step(T reg) {
    const int nq = (N + TEAM) / TEAM;
    for (int q = nq - 1; q >= 0; --q) {
      const int k0 = q * TEAM, k = k0 + lane;
      if (k < N) {
        stage_terms(k, chunk + lane * SVP);
      } else if (k == N) {
        T P[NA][NA], p[NA];
        terminal_Pp(P, p);
        for (int i = 0; i < NA; ++i) {
          for (int j = 0; j < NA; ++j) sc[S_P + i * NA + j] = P[i][j];
          sc[S_PV + i] = p[i];
        }
      }
      sync();
      const int k1 = k0 + TEAM < N ? k0 + TEAM : N;
      for (int kk = k1 - 1; kk >= k0; --kk) riccati_stage(kk, chunk + (kk - k0) * SVP, reg);
    }

    // free dtau (variable uniform dt only): max(P_tau, tiny) that keeps a
    // NaN (fmax would drop it)
    if constexpr (NONU) {
      dtau = T(0);
    } else {
      const T Ptau = sc[S_P + NA * NA - 1] + reg;
      const T den = Ptau < tiny<T>() ? tiny<T>() : Ptau;
      dtau = vdt ? -sc[S_PV + NA - 1] / den : T(0);
    }

    // forward rollout from z_0 = [0, 0, dtau] (ddt_{-1} = 0 on the
    // non-uniform grid); z double-buffered in the scratch
    T* z = sc + S_Z;
    if (lane < NA) z[lane] = lane == NA - 1 ? dtau : T(0);
    if (lane < NX) dxs(0, lane) = T(0);
    int cur = 0;
    for (int k0 = 0; k0 < N; k0 += TEAM) {
      if (k0 + lane < N) stage_transition(k0 + lane, chunk + lane * SVP);
      sync();
      const int k1 = k0 + TEAM < N ? k0 + TEAM : N;
      for (int k = k0; k < k1; ++k) {
        if (lane < NA) {
          const T* s = chunk + (k - k0) * SVP;
          const T* zc = z + cur * NA;
          T u[NV];
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            T acc = T(0);
#pragma unroll
            for (int j = 0; j < NA; ++j) acc += Kt(k, i, j) * zc[j];
            u[i] = acc + kft(k, i);
          }
          T acc = T(0);
#pragma unroll
          for (int j = 0; j < NA; ++j) acc += s[O_FZ + lane * NA + j] * zc[j];
          T accu = T(0);
#pragma unroll
          for (int l = 0; l < NV; ++l) accu += s[O_GZ + lane * NV + l] * u[l];
          const T zn = acc + accu + s[O_RZ + lane];
          z[(cur ^ 1) * NA + lane] = zn;
          if (lane < NU) dus(k, lane) = u[lane];
          if (NONU && lane == NU) dtaus(k) = u[NU];
          if (lane < NX) dxs(k + 1, lane) = zn;
        }
        cur ^= 1;
        sync();
      }
    }

    // NaN quarantine: a non-finite step becomes a zero step, whole (a team
    // vote)
    bool bad = !isfinite(dtau);
    for (int k = lane; k < N; k += TEAM) {
      for (int i = 0; i < NX; ++i) bad = bad || !isfinite(dxs(k + 1, i));
      for (int i = 0; i < NU; ++i) bad = bad || !isfinite(dus(k, i));
      if constexpr (NONU) bad = bad || !isfinite(dtaus(k));
    }
    if (team_any(bad)) {
      dtau = T(0);
      for (int k = lane; k <= N; k += TEAM)
        for (int i = 0; i < NX; ++i) dxs(k, i) = T(0);
      for (int k = lane; k < N; k += TEAM) {
        for (int i = 0; i < NU; ++i) dus(k, i) = T(0);
        if constexpr (NONU) dtaus(k) = T(0);
      }
    }
    sync();
  }

  // ---- via points (the Pallas via_sweep and via_rows)

  // Via slot j's first minimum over the states k0 .. N of the squared
  // position distance (torch.argmin's: a NaN is the least, and wins once),
  // over the candidate xs + al dxs (cand) or the current states: each lane
  // scans its stages in order, then the team keeps the NaN or the least
  // value of the lowest stage. bk is k0 where no stage beats +inf.
  __device__ __forceinline__ void via_best(int j, int k0, T al, bool cand, T& bd, int& bk) const {
    const T vx = vp[3 * j], vy = vp[3 * j + 1];
    T d = T(INFINITY);
    int idx = INT_MAX;
    for (int k = k0 + lane; k <= N; k += TEAM) {
      T px = xs[k * NX], py = xs[k * NX + 1];
      if (cand) {
        px += al * dxs(k, 0);
        py += al * dxs(k, 1);
      }
      const T ex = px - vx, ey = py - vy;
      const T d2 = mul_rn(ex, ex) + mul_rn(ey, ey);
      if (d2 < d || (d2 != d2 && d == d)) {
        d = d2;
        idx = k;
      }
    }
#pragma unroll
    for (int o = TEAM / 2; o > 0; o >>= 1) {
      const T od = __shfl_xor_sync(mask, d, o);
      const int oi = __shfl_xor_sync(mask, idx, o);
      const bool on = od != od, dn = d != d;
      if (on ? (!dn || oi < idx) : (!dn && (od < d || (od == d && oi < idx)))) {
        d = od;
        idx = oi;
      }
    }
    bd = d;
    bk = idx == INT_MAX ? k0 : idx;
  }

  // each via slot's stage at the current states, into vks (ordered: from
  // the cursor on, which an active slot moves to its stage)
  __device__ __forceinline__ void via_assign() const {
    int cursor = 0;
    for (int j = 0; j < mv; ++j) {
      T bd;
      int bk;
      via_best(j, via_ordered ? cursor : 0, T(0), false, bd, bk);
      if (lane == 0) vks[j] = bk;
      if (via_ordered && vm[j] != 0) cursor = bk;
    }
    sync();
  }

  // the summed attraction of the active via slots, pw d2 + ow wrap(theta -
  // theta_v)^2 (the orientation term where ow > 0), each slot at its own
  // assignment over the candidate (cand) or the current states
  __device__ __forceinline__ T via_cost(T al, bool cand) const {
    T acc = T(0);
    int cursor = 0;
    for (int j = 0; j < mv; ++j) {
      T bd;
      int bk;
      via_best(j, via_ordered ? cursor : 0, al, cand, bd, bk);
      const bool on = vm[j] != 0;
      if (via_ordered && on) cursor = bk;
      if (on) {
        T c = via_pw * bd;
        if (via_ow > T(0)) {
          T th = xs[bk * NX + 2];
          if (cand) th = wrap(th + al * dxs(bk, 2));
          const T e = wrap(th - vp[3 * j + 2]);
          c += via_ow * e * e;
        }
        acc += c;
      }
    }
    return acc;
  }

  // the exact gradient and diagonal Hessian rows of the via attraction at
  // state k (at x), added in place: each active slot that claims stage k
  // adds 2 pw (x - v) and 2 pw on x and y, and where ow > 0, 2 ow
  // wrap(theta - theta_v) and 2 ow on theta
  __device__ __forceinline__ void via_rows(const T x[NX], int k, T h[NA], T H[NA][NA]) const {
    for (int j = 0; j < mv; ++j) {
      if (vks[j] != k || !vm[j]) continue;
      const T cp = T(2) * via_pw;
      h[0] += cp * (x[0] - vp[3 * j]);
      h[1] += cp * (x[1] - vp[3 * j + 1]);
      H[0][0] += cp;
      H[1][1] += cp;
      if (via_ow > T(0)) {
        const T co = T(2) * via_ow;
        h[2] += co * wrap(x[2] - vp[3 * j + 2]);
        H[2][2] += co;
      }
    }
  }

  // ---- the line search

  // the candidate's pose k, (xs + al dxs) with theta wrapped
  __device__ __forceinline__ void cand_x(int k, T al, T x[NX]) const {
    x[0] = xs[k * NX + 0] + al * dxs(k, 0);
    x[1] = xs[k * NX + 1] + al * dxs(k, 1);
    x[2] = wrap(xs[k * NX + 2] + al * dxs(k, 2));
  }
  __device__ __forceinline__ void cand_u(int k, T al, T u[NU]) const {
    for (int i = 0; i < NU; ++i)
      u[i] = k < 0 ? u_prev[i] : us[k * NU + i] + al * dus(k, i);
  }
  // the candidate's dt of stage k on the non-uniform grid
  __device__ __forceinline__ T cand_dt(int k, T al) const {
    if constexpr (NONU) return clip(this->dts[k] + al * dtaus(k), dt_lo, dt_hi);
    return T(0);
  }

  // the AL merit of the candidate (xs + al dxs [theta wrapped], us + al dus,
  // clip(dt + al dtau)): each lane sums its stages' terms, the team sums the
  // lanes', and every lane adds the terminal terms; on the non-uniform grid
  // each stage's clip(dt_k + al ddt_k), its dt box and, for minimum time,
  // its cost dt_k, the slots predicted to the candidate's cumulative time
  // (each lane sums the stages' dt from stage 0 in order)
  __device__ __forceinline__ T merit(T al) const {
    const T dtv = NONU ? T(0) : clip(dt + al * dtau, dt_lo, dt_hi);
    T eq_lin = T(0), eq_sq = T(0), ineq = T(0), cost = T(0);
    T tc = T(0);
    int tdone = 0;  // the non-uniform grid: tc sums the candidate's dt of stages < tdone
    for (int k = lane; k < N; k += TEAM) {
      T xk[NX], xk1[NX], uk[NU], up[NU], c[NX];
      cand_x(k, al, xk);
      cand_x(k + 1, al, xk1);
      cand_u(k, al, uk);
      cand_u(k - 1, al, up);
      T dk = dtv, dtp = T(0);
      if constexpr (NONU) {
        dk = cand_dt(k, al);
        if (k > 0) dtp = cand_dt(k - 1, al);
        while (tdone <= k) tc += cand_dt(tdone++, al);
      }
      defect_value(xk, uk, xk1, dk, c);
      for (int i = 0; i < NX; ++i) {
        eq_lin += ld[k * NX + i] * c[i];
        eq_sq += c[i] * c[i];
      }
      // obstacle row k belongs to pose x_{k+1}, predicted at the
      // candidate's dt
      if (M > 0) {
        Foot<T> D;
        foot_at(xk1, D);
        const T t = NONU ? (moving() ? tc : T(0)) : pose_time(k + 1, dtv);
        for (int j = 0; j < M; ++j) {
          const T mu = mo[k * M + j];
          const T a = hinge(mu + rho * obs_row<false>(D, j, t, nullptr));
          ineq += a * a - mu * mu;
        }
      }
      T gr[4], gb[4];
      rate_g(uk, up, dk, gr);
      box_g(uk, gb);
      for (int i = 0; i < 4; ++i) {
        const T mu_r = mr[k * 4 + i], mu_b = mb[k * 4 + i];
        const T ar = hinge(mu_r + rho * gr[i]), ab = hinge(mu_b + rho * gb[i]);
        ineq += (ar * ar - mu_r * mu_r) + (ab * ab - mu_b * mu_b);
      }
      if constexpr (NONU) {
        // the interval's dt box; minimum time: the stage cost dt_k
        const T gdt[2] = {dk - dt_max, dt_min - dk};
        for (int i = 0; i < 2; ++i) {
          const T a = hinge(md[2 * k + i] + rho * gdt[i]);
          ineq += a * a - md[2 * k + i] * md[2 * k + i];
        }
        if constexpr (!QUAD) cost += dk;
      }
      if constexpr (QUAD) cost += stage_cost(xk, uk, dk, k, dtp);
    }
    cost = team_sum(cost);
    eq_lin = team_sum(eq_lin);
    eq_sq = team_sum(eq_sq);
    ineq = team_sum(ineq);
    if constexpr (!QUAD && !NONU) cost += T(N) * dtv;
    // terminal equality at the candidate x_N
    T xN[NX];
    cand_x(N, al, xN);
    const T gd[NX] = {xN[0] - xf[0], xN[1] - xf[1], wrap(xN[2] - xf[2])};
    for (int i = 0; i < NX; ++i) {
      if (fixed[i]) {
        eq_lin += lt[i] * gd[i];
        eq_sq += gd[i] * gd[i];
      }
    }
    cost += terminal_cost(xN, NONU ? cand_dt(N - 1, al) : dtv);
    // the via attraction, from the candidate's own assignment (funcs.cost)
    if constexpr (VIA) cost += via_cost(al, true);
    // dt box (variable uniform dt only), and the terminal ball's row (a
    // disabled ball keeps the constant row g = -BIG, as the port's merit does)
    if (vdt && !NONU) {
      const T gdt[2] = {dtv - dt_max, dt_min - dtv};
      for (int i = 0; i < 2; ++i) {
        const T a = hinge(md[i] + rho * gdt[i]);
        ineq += a * a - md[i] * md[i];
      }
    }
    T gp[NX];
    const T ab = hinge(mball[0] + rho * (ball_on ? ball_g(xN, gp) : -T(BIG)));
    ineq += ab * ab - mball[0] * mball[0];
    return cost + eq_lin + T(0.5) * rho * eq_sq + ineq / (T(2) * rho);
  }
};

// The blocks per SM that ptxas budgets registers for (__launch_bounds__):
// as many as the teams' shared budget lets an SM hold (SMEM_SM, less the
// 1 KB each block keeps), so that registers never hold the occupancy below
// what shared memory allows: five blocks of two teams in float at the
// default budget, two in double.
template <typename T>
struct MinBlocks {
  static constexpr int value = SMEM_SM / (TEAMS * team_budget(sizeof(T)) + 1024) > 1
                                   ? SMEM_SM / (TEAMS * team_budget(sizeof(T)) + 1024)
                                   : 1;
};

template <typename T, int MODEL, int OBJ, int GEO, bool NONU, int COLLOC>
__global__ void __launch_bounds__(BLOCK, MinBlocks<T>::value)
    k2a_kernel(const K2aArgs<T> a, const __grid_constant__ K2aParams prm, const Layout lay) {
  constexpr bool QUAD = OBJ == OBJ_QUADRATIC;
  constexpr bool VIA = OBJ == OBJ_VIA;
  const int team = threadIdx.x / TEAM;
  const int b = blockIdx.x * TEAMS + team;
  if (b >= a.B) return;  // the whole team
  const int N = prm.N, M = prm.M;
  Lane<T, MODEL, OBJ, GEO, NONU, COLLOC> L;
  L.lane = threadIdx.x % TEAM;
  L.mask = TEAM == 32 ? 0xffffffffu : ((1u << TEAM) - 1u) << (threadIdx.x % 32 / TEAM * TEAM);
  const int lane = L.lane;
  L.N = N;
  L.M = M;
  L.Mc = prm.Mc;
  L.Ml = prm.Ml;
  L.Mg = prm.Mg;
  L.V = prm.V;
  L.n_disc = prm.n_disc;
  L.fp_nv = prm.fp_nv;
  L.fp_v = prm.fp_v;  // read in place: a __grid_constant__ parameter is not copied
  L.dynamic = prm.dynamic != 0;
  L.rot = false;
  for (int i = 0; i < 2; ++i) {
    L.disc_off[i] = T(prm.disc_off[i]);
    L.disc_r[i] = T(prm.disc_r[i]);
    L.rot = L.rot || (i < prm.n_disc && prm.disc_off[i] != 0.0);
  }
  L.wb = T(prm.wheelbase);
  L.bike_a = T(prm.bike_a);
  L.bike_lr = T(prm.bike_lr);
  L.min_dist = T(prm.min_dist);
  L.dt_min = T(prm.dt_min);
  L.dt_max = T(prm.dt_max);
  L.dt_lo = T(prm.dt_lo);
  L.dt_hi = T(prm.dt_hi);
  for (int i = 0; i < NU; ++i) {
    L.lo_u[i] = T(prm.lo_u[i]);
    L.hi_u[i] = T(prm.hi_u[i]);
    L.lo_r[i] = T(prm.lo_r[i]);
    L.hi_r[i] = T(prm.hi_r[i]);
  }
  for (int i = 0; i < NX; ++i) {
    L.fixed[i] = prm.xf_fixed[i] != 0;
    L.q[i] = T(prm.q[i]);
    L.qf[i] = T(prm.qf[i]);
    L.ball_w[i] = T(prm.ball_w[i]);
  }
  for (int i = 0; i < NU; ++i) L.r[i] = T(prm.r[i]);
  L.hybrid = T(prm.hybrid);
  L.ball_r = T(prm.ball_r);
  L.integral = prm.integral != 0;
  L.trapezoidal = prm.trapezoidal != 0;
  L.has_qf = prm.has_qf != 0;
  L.ball_on = prm.ball_r > 0.0;
  L.vdt = prm.variable_dt != 0;
  const size_t bb = static_cast<size_t>(b);
  L.xf = a.xf + bb * NX;
  L.u_prev = a.u_prev + bb * NU;
  L.oc = a.oc + bb * prm.Mc * 2;
  L.orad = a.orad + bb * prm.Mc;
  L.ovel = a.ovel + bb * prm.Mc * 2;
  L.omask = a.omask + bb * prm.Mc;
  L.ln = a.ln + bb * prm.Ml * 4;
  L.lvel = a.lvel + bb * prm.Ml * 2;
  L.lmask = a.lmask + bb * prm.Ml;
  L.pg = a.pg + bb * prm.Mg * prm.V * 2;
  L.pvel = a.pvel + bb * prm.Mg * 2;
  L.pnv = a.pnv + bb * prm.Mg;
  L.pmask = a.pmask + bb * prm.Mg;
  if constexpr (VIA) {
    L.mv = prm.mv;
    L.via_ordered = prm.via_ordered != 0;
    L.via_pw = T(prm.via_pw);
    L.via_ow = T(prm.via_ow);
    L.vp = a.vp + bb * prm.mv * 3;
    L.vm = a.vmask + bb * prm.mv;
  }
  if constexpr (NONU) {
    L.dt_ref = T(prm.dt_ref);
    L.dt_prox = T(prm.dt_prox);
  }
  if constexpr (COLLOC == COLLOC_OTHER) {
    L.rule = prm.colloc;
    L.rk_stages = prm.rk_stages;
    L.rk_substeps = prm.rk_substeps;
    L.rk_a = prm.rk_a;
    L.rk_b = prm.rk_b;
  }

  // ---- the team's working state (Layout): the scratch and the vks in
  // shared memory, each array in shared memory or, where it does not fit,
  // in its output tensor or in the scenario's workspace
  unsigned char* const tsm = k2a_smem + static_cast<size_t>(team) * lay.team_bytes;
  L.vks = reinterpret_cast<int*>(tsm);
  T* const sv = reinterpret_cast<T*>(tsm + VKS_BYTES);
  T* const wsb = a.ws + bb * lay.ws;
  const auto at = [&](int arr, T* out) -> T* {
    return ((lay.shared >> arr) & 1) ? sv + lay.off[arr] : (out ? out : wsb + lay.off[arr]);
  };
  const size_t nx1 = static_cast<size_t>(N + 1) * NX, nu = static_cast<size_t>(N) * NU;
  const size_t nmd = NONU ? 2 * N : 2;
  L.sc = sv;
  L.lt = sv + S_LT;
  L.mball = sv + S_MBALL;
  L.xs = at(A_XS, a.xs + bb * nx1);
  L.us = at(A_US, a.us + bb * nu);
  L.ld = at(A_LD, a.ld + bb * N * NX);
  L.mo = at(A_MO, a.mo + bb * N * M);
  L.mr = at(A_MR, a.mr + bb * N * 4);
  L.mb = at(A_MB, a.mb + bb * N * 4);
  L.md = at(A_MD, a.md + bb * nmd);
  L.dxs_p = at(A_DXS, nullptr);
  L.dus_p = at(A_DUS, nullptr);
  L.chunk = at(A_CHUNK, nullptr);
  L.tape = at(A_TAPE, nullptr);
  L.bxs_p = at(A_BXS, nullptr);
  L.bus_p = at(A_BUS, nullptr);
  if constexpr (NONU) {
    L.dts = at(A_DTS, a.dt + bb * N);
    L.dtaus_p = at(A_DTAUS, nullptr);
    L.bdts_p = at(A_BDTS, nullptr);
    L.tv_p = at(A_TV, nullptr);
  }

  // ---- state init: the inputs become the working state, copied by the
  // team with neighbouring lanes on neighbouring values ------------------ //
  const auto copy = [&](T* dst, const T* src, size_t n) {
    for (size_t i = lane; i < n; i += TEAM) dst[i] = src[i];
  };
  copy(L.xs, a.xs_i + bb * nx1, nx1);
  copy(L.us, a.us_i + bb * nu, nu);
  copy(L.ld, a.ld_i + bb * N * NX, static_cast<size_t>(N) * NX);
  copy(L.mo, a.mo_i + bb * N * M, static_cast<size_t>(N) * M);
  copy(L.mr, a.mr_i + bb * N * 4, static_cast<size_t>(N) * 4);
  copy(L.mb, a.mb_i + bb * N * 4, static_cast<size_t>(N) * 4);
  copy(L.md, a.md_i + bb * nmd, nmd);  // on the non-uniform grid one pair per interval
  copy(L.lt, a.lt_i + bb * NX, NX);
  copy(L.mball, a.mball_i + bb, 1);
  if constexpr (NONU) {
    copy(L.dts, a.dt_i + bb * N, N);
    L.sync();
    // the derivatives predict dynamic slots at the initial dt's cumulative
    // times
    if (lane == 0) {
      T t = T(0);
      for (int k = 0; k < N; ++k) {
        L.tv(k) = t;
        t += L.dts[k];
      }
      L.tv(N) = t;
    }
    L.dt = T(0);
    L.dt0 = T(0);
  } else {
    L.dt = a.dt_i[b];
    L.dt0 = L.dt;  // the derivatives predict dynamic slots at the initial dt
  }
  L.rho = a.rho_i[b];
  L.sync();

  const T inf = T(INFINITY);
  T viol_prev = inf, eq_last = inf, in_last = inf;
  T best_dt = L.dt, best_eq = inf, best_in = inf;
  bool found = false;
  const T reg0 = T(prm.reg0), tol_eq = T(prm.tol_eq), tol_ineq = T(prm.tol_ineq);

  for (int phase = 0; phase < prm.n_al; ++phase) {
    T reg = reg0;  // reg restarts each phase: the dual update reshapes the merit
    for (int it = 0; it < prm.n_sqp; ++it) {
      // the via points' stage assignment at the current states: stage data
      // of this iteration's derivatives (al_sqp._via_weights)
      if constexpr (VIA) L.via_assign();
      L.kkt_step(reg);

      // ---- line search: dt trust cap, candidates in order, alpha = 0 last
      T cap;
      if constexpr (NONU) {
        // the least over the stages, each stage's dt floored at dt_ref
        cap = T(1);
        for (int k = lane; k < N; k += TEAM) {
          const T adk = fabs(L.dtaus(k));
          const T ck = adk > T(0) ? vmin(T(prm.dt_trust_frac) * vmax(L.dts[k], L.dt_ref) /
                                             vmax(adk, T(1e-30)),
                                         T(1))
                                  : T(1);
          cap = vmin(cap, ck);
        }
        cap = L.team_vmin(cap);
      } else {
        const T adt = fabs(L.dtau);
        cap = adt > T(0) ? vmin(T(prm.dt_trust_frac) * L.dt / vmax(adt, T(1e-30)), T(1))
                         : T(1);
      }
      T best_m = inf, best_a = T(0);
      bool accepted = false;
      for (int c = 0; c < prm.n_alpha; ++c) {
        const T al = a.alphas[c] * cap;
        T m = L.merit(al);
        if (!isfinite(m)) m = inf;
        if (m < best_m) {
          best_m = m;
          best_a = al;
          accepted = al > T(0);
        }
      }
      T m0 = L.merit(T(0));
      m0 = isfinite(m0) ? vmin(m0, largest<T>()) : largest<T>();
      if (m0 < best_m) {
        best_a = T(0);
        accepted = false;
      }
      L.sync();  // every lane has read the states it applies the step to

      // ---- apply the winning candidate; reg shrinks or grows
      for (int k = lane; k <= N; k += TEAM) {
        L.xs[k * NX + 0] += best_a * L.dxs(k, 0);
        L.xs[k * NX + 1] += best_a * L.dxs(k, 1);
        L.xs[k * NX + 2] = wrap(L.xs[k * NX + 2] + best_a * L.dxs(k, 2));
      }
      for (int k = lane; k < N; k += TEAM) {
        for (int i = 0; i < NU; ++i) L.us[k * NU + i] += best_a * L.dus(k, i);
        if constexpr (NONU) L.dts[k] = clip(L.dts[k] + best_a * L.dtaus(k), L.dt_lo, L.dt_hi);
      }
      if constexpr (!NONU) L.dt = clip(L.dt + best_a * L.dtau, L.dt_lo, L.dt_hi);
      reg = accepted ? vmax(reg * T(prm.reg_shrink), T(prm.reg_min))
                     : vmin(vmax(reg, reg0) * T(prm.reg_grow), T(prm.reg_max));
      L.sync();
    }

    // ---- dual update with conditional rho growth: each lane its stages,
    // the violation maxima over the team ---------------------------------- //
    const T rho = L.rho;
    T eq_m = T(0), in_m = -inf;
    T tc = T(0);  // the non-uniform grid: the time of x_{k+1}
    int tdone = 0;
    for (int k = lane; k < N; k += TEAM) {
      T xk[NX], uk[NU], up[NU], xk1[NX], c[NX];
      L.x_at(k, xk);
      L.u_at(k, uk);
      L.uprev_at(k, up);
      L.x_at(k + 1, xk1);
      if constexpr (NONU)
        while (tdone <= k) tc += L.dts[tdone++];
      L.defect_value(xk, uk, xk1, L.dt_at(k), c);
      for (int i = 0; i < NX; ++i) {
        L.ld[k * NX + i] += rho * c[i];
        eq_m = vmax(eq_m, T(fabs(c[i])));
      }
      if (M > 0) {
        // predicted at the current dt
        Foot<T> D;
        L.foot_at(xk1, D);
        const T t = NONU ? (L.moving() ? tc : T(0)) : L.pose_time(k + 1, L.dt);
        for (int j = 0; j < M; ++j) {
          const T g = L.template obs_row<false>(D, j, t, nullptr);
          L.mo[k * M + j] = hinge(L.mo[k * M + j] + rho * g);
          in_m = vmax(in_m, g);
        }
      }
      T gr[4], gb[4];
      L.rate_g(uk, up, L.dt_at(k), gr);
      L.box_g(uk, gb);
      for (int i = 0; i < 4; ++i) {
        L.mr[k * 4 + i] = hinge(L.mr[k * 4 + i] + rho * gr[i]);
        L.mb[k * 4 + i] = hinge(L.mb[k * 4 + i] + rho * gb[i]);
        in_m = vmax(in_m, vmax(gr[i], gb[i]));
      }
      if constexpr (NONU) {
        // the interval's dt box
        const T dk = L.dts[k];
        const T gdt[2] = {dk - L.dt_max, L.dt_min - dk};
        for (int i = 0; i < 2; ++i) {
          L.md[2 * k + i] = hinge(L.md[2 * k + i] + rho * gdt[i]);
          in_m = vmax(in_m, gdt[i]);
        }
      }
    }
    eq_m = L.team_vmax(eq_m);
    in_m = L.team_vmax(in_m);
    // the terminal rows, the same on every lane; lane 0 moves their
    // multipliers
    T xN[NX];
    L.x_at(N, xN);
    const T gd[NX] = {xN[0] - L.xf[0], xN[1] - L.xf[1], wrap(xN[2] - L.xf[2])};
    for (int i = 0; i < NX; ++i) {
      if (L.fixed[i]) {
        if (lane == 0) L.lt[i] += rho * gd[i];
        eq_m = vmax(eq_m, T(fabs(gd[i])));
      } else if (lane == 0) {
        L.lt[i] = T(0);
      }
    }
    // the terminal ball (a disabled ball's row g = -BIG clamps its multiplier
    // to 0); the dt box, whose multipliers move on a variable dt only (a
    // fixed dt's rows are the constant -BIG)
    T gp[NX];
    const T gball = L.ball_on ? L.ball_g(xN, gp) : T(-BIG);
    if (lane == 0) L.mball[0] = hinge(L.mball[0] + rho * gball);
    in_m = vmax(in_m, gball);
    if (L.vdt && !NONU) {
      const T gdt[2] = {L.dt - L.dt_max, L.dt_min - L.dt};
      for (int i = 0; i < 2; ++i) {
        if (lane == 0) L.md[i] = hinge(L.md[i] + rho * gdt[i]);
        in_m = vmax(in_m, gdt[i]);
      }
    } else {
      in_m = vmax(in_m, T(-BIG));
    }
    in_m = hinge(in_m);
    const T viol = vmax(eq_m, in_m);
    const bool grow = viol > T(prm.viol_decrease_req) * viol_prev || viol > T(0.05) * tol_eq;
    L.rho = grow ? vmin(rho * T(prm.rho_growth), T(prm.rho_max)) : rho;
    viol_prev = viol;
    eq_last = eq_m;
    in_last = in_m;

    // ---- best-feasible snapshot ---------------------------------------- //
    if (eq_m < tol_eq && in_m < tol_ineq) {
      for (int k = lane; k <= N; k += TEAM)
        for (int i = 0; i < NX; ++i) L.bxs(k, i) = L.xs[k * NX + i];
      for (int k = lane; k < N; k += TEAM) {
        for (int i = 0; i < NU; ++i) L.bus(k, i) = L.us[k * NU + i];
        if constexpr (NONU) L.bdts(k) = L.dts[k];
      }
      best_dt = L.dt;
      best_eq = eq_m;
      best_in = in_m;
      found = true;
    }
    L.sync();
  }

  // ---- final selection (select, not blend) and outputs ------------------ //
  const bool final_ok = eq_last < tol_eq && in_last < tol_ineq;
  const bool use_best = found && !final_ok;
  if (use_best) {
    for (int k = lane; k <= N; k += TEAM)
      for (int i = 0; i < NX; ++i) L.xs[k * NX + i] = L.bxs(k, i);
    for (int k = lane; k < N; k += TEAM) {
      for (int i = 0; i < NU; ++i) L.us[k * NU + i] = L.bus(k, i);
      if constexpr (NONU) L.dts[k] = L.bdts(k);
    }
  }
  L.sync();
  const T dt_fin = use_best ? best_dt : L.dt;
  T cost = T(0);
  if constexpr (QUAD) {
    for (int k = lane; k < N; k += TEAM) {
      T xk[NX], uk[NU];
      L.x_at(k, xk);
      L.u_at(k, uk);
      const T dk = NONU ? L.dt_at(k) : dt_fin;
      const T dtp = NONU && k > 0 ? L.dt_at(k - 1) : T(0);
      cost += L.stage_cost(xk, uk, dk, k, dtp);
    }
    cost = L.team_sum(cost);
  } else {
    if constexpr (NONU) {
      for (int k = lane; k < N; k += TEAM) cost += L.dts[k];  // sum_k dt_k
      cost = L.team_sum(cost);
    } else {
      cost = T(N) * dt_fin;
    }
    if constexpr (VIA) cost += L.via_cost(T(0), false);  // the selected states
  }
  T xN_fin[NX];
  L.x_at(N, xN_fin);
  cost += L.terminal_cost(xN_fin, NONU ? L.dt_at(N - 1) : dt_fin);

  // ---- the working state out: each array that lived in shared memory into
  // its output, the team's lanes on neighbouring values
  const auto out = [&](int arr, T* dst, const T* src, size_t n) {
    if ((lay.shared >> arr) & 1) copy(dst, src, n);
  };
  out(A_XS, a.xs + bb * nx1, L.xs, nx1);
  out(A_US, a.us + bb * nu, L.us, nu);
  out(A_LD, a.ld + bb * N * NX, L.ld, static_cast<size_t>(N) * NX);
  out(A_MO, a.mo + bb * N * M, L.mo, static_cast<size_t>(N) * M);
  out(A_MR, a.mr + bb * N * 4, L.mr, static_cast<size_t>(N) * 4);
  out(A_MB, a.mb + bb * N * 4, L.mb, static_cast<size_t>(N) * 4);
  out(A_MD, a.md + bb * nmd, L.md, nmd);
  if constexpr (NONU) out(A_DTS, a.dt + bb * N, L.dts, N);
  copy(a.lt + bb * NX, L.lt, NX);
  if (lane == 0) {
    a.mball[b] = L.mball[0];
    if constexpr (!NONU) a.dt[b] = dt_fin;
    a.rho[b] = L.rho;
    a.cost[b] = cost;
    a.eq[b] = use_best ? best_eq : eq_last;
    a.ineq[b] = use_best ? best_in : in_last;
    a.conv[b] = (final_ok || found) ? 1 : 0;
  }
}

template <typename T, int MODEL, int OBJ, bool NONU, int COLLOC>
int launch_as(const K2aArgs<T>& a, const K2aParams& prm, const Layout& lay, cudaStream_t stream,
              int* occupancy) {
  const int blocks = (a.B + TEAMS - 1) / TEAMS;
  const int smem = TEAMS * lay.team_bytes;
  const auto go = [&](auto kernel) -> int {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (occupancy)
      return static_cast<int>(
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, BLOCK, smem));
    kernel<<<blocks, BLOCK, smem, stream>>>(a, prm, lay);
    return static_cast<int>(cudaGetLastError());
  };
  const bool plain_slots = prm.Ml == 0 && prm.Mg == 0 && prm.dynamic == 0;
  if (prm.fp_kind == FP_LINE)
    return go(k2a_kernel<T, MODEL, OBJ, GEO_FP_LINE | GEO_SLOTS, NONU, COLLOC>);
  if (prm.fp_kind == FP_POLYGON && plain_slots)
    return go(k2a_kernel<T, MODEL, OBJ, GEO_FP_POLYGON, NONU, COLLOC>);
  if (prm.fp_kind == FP_POLYGON)
    return go(k2a_kernel<T, MODEL, OBJ, GEO_FP_POLYGON | GEO_SLOTS, NONU, COLLOC>);
  if (plain_slots && prm.n_disc == 1 && prm.disc_off[0] == 0.0)
    return go(k2a_kernel<T, MODEL, OBJ, GEO_NONE, NONU, COLLOC>);
  return go(k2a_kernel<T, MODEL, OBJ, GEO_ALL, NONU, COLLOC>);
}

bool params_ok(const K2aParams* prm) {
  return !(prm->N <= 0 || prm->M < 0 || prm->n_alpha <= 0 || prm->n_al <= 0 ||
      prm->n_sqp <= 0 || prm->mv < 0 || prm->mv > MAX_VIA || (prm->quadratic && prm->mv > 0) ||
      prm->model < UNICYCLE || prm->model > BICYCLE || prm->Mc < 0 || prm->Ml < 0 ||
      prm->Mg < 0 || prm->Mc + prm->Ml + prm->Mg != prm->M || prm->V > MAX_V ||
      (prm->Mg > 0 && prm->V < 1) || prm->n_disc < 1 || prm->n_disc > 2 ||
      prm->fp_kind < FP_DISCS || prm->fp_kind > FP_POLYGON ||
      (prm->fp_kind == FP_LINE && prm->fp_nv != 2) ||
      (prm->fp_kind == FP_POLYGON && (prm->fp_nv < 1 || prm->fp_nv > MAX_FP_V)) ||
      prm->nonu != K2A_NONU || (prm->nonu && !prm->variable_dt) || prm->model != K2A_MODEL ||
      (prm->quadratic ? OBJ_QUADRATIC : prm->mv > 0 ? OBJ_VIA : OBJ_MIN_TIME) != K2A_OBJ ||
      prm->colloc < RULE_FORWARD || prm->colloc > RULE_SHOOTING ||
      (prm->colloc == RULE_FORWARD ? COLLOC_FD : COLLOC_OTHER) != K2A_COLLOC ||
      (prm->colloc == RULE_SHOOTING &&
       (prm->rk_stages < 1 || prm->rk_stages > MAX_RK || prm->rk_substeps < 1 ||
        prm->rk_substeps > MAX_SUBSTEPS || prm->rk_stages * prm->rk_substeps > MAX_RK_EVALS)));
}

using Working = std::conditional_t<K2A_DOUBLE != 0, double, float>;

template <typename T>
int launch(const K2aParams* prm, const void* const* in, void* const* out, void* ws, int B,
           void* stream, int* occupancy) {
  if (B <= 0 || !params_ok(prm)) return static_cast<int>(cudaErrorInvalidValue);
  K2aArgs<T> a;
  a.xs_i = static_cast<const T*>(in[0]);
  a.us_i = static_cast<const T*>(in[1]);
  a.dt_i = static_cast<const T*>(in[2]);
  a.xf = static_cast<const T*>(in[3]);
  a.u_prev = static_cast<const T*>(in[4]);
  a.oc = static_cast<const T*>(in[5]);
  a.orad = static_cast<const T*>(in[6]);
  a.omask = static_cast<const unsigned char*>(in[7]);
  a.ovel = static_cast<const T*>(in[8]);
  a.ln = static_cast<const T*>(in[9]);
  a.lvel = static_cast<const T*>(in[10]);
  a.lmask = static_cast<const unsigned char*>(in[11]);
  a.pg = static_cast<const T*>(in[12]);
  a.pnv = static_cast<const int*>(in[13]);
  a.pvel = static_cast<const T*>(in[14]);
  a.pmask = static_cast<const unsigned char*>(in[15]);
  a.ld_i = static_cast<const T*>(in[16]);
  a.lt_i = static_cast<const T*>(in[17]);
  a.mo_i = static_cast<const T*>(in[18]);
  a.mr_i = static_cast<const T*>(in[19]);
  a.mb_i = static_cast<const T*>(in[20]);
  a.md_i = static_cast<const T*>(in[21]);
  a.mball_i = static_cast<const T*>(in[22]);
  a.rho_i = static_cast<const T*>(in[23]);
  a.vp = static_cast<const T*>(in[24]);
  a.vmask = static_cast<const unsigned char*>(in[25]);
  a.alphas = static_cast<const T*>(in[26]);
  a.ws = static_cast<T*>(ws);
  a.xs = static_cast<T*>(out[0]);
  a.us = static_cast<T*>(out[1]);
  a.dt = static_cast<T*>(out[2]);
  a.ld = static_cast<T*>(out[3]);
  a.lt = static_cast<T*>(out[4]);
  a.mo = static_cast<T*>(out[5]);
  a.mr = static_cast<T*>(out[6]);
  a.mb = static_cast<T*>(out[7]);
  a.md = static_cast<T*>(out[8]);
  a.mball = static_cast<T*>(out[9]);
  a.rho = static_cast<T*>(out[10]);
  a.cost = static_cast<T*>(out[11]);
  a.eq = static_cast<T*>(out[12]);
  a.ineq = static_cast<T*>(out[13]);
  a.conv = static_cast<unsigned char*>(out[14]);
  a.B = B;
  const Layout lay = make_layout(prm->N, prm->M, K2A_NONU != 0, sizeof(T));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_as<T, K2A_MODEL, K2A_OBJ, K2A_NONU != 0, K2A_COLLOC>(a, *prm, lay, s, occupancy);
}

}  // namespace

extern "C" {

int k2a_max_v() { return MAX_V; }
int k2a_max_fp_v() { return MAX_FP_V; }
int k2a_max_via() { return MAX_VIA; }
// this build's group: K2A_DOUBLE, K2A_MODEL, K2A_OBJ, K2A_NONU, K2A_COLLOC
// as the digits of one number
int k2a_group() {
  return (((K2A_DOUBLE * 10 + K2A_MODEL) * 10 + K2A_OBJ) * 10 + K2A_NONU) * 10 + K2A_COLLOC;
}
int k2a_params_size() { return static_cast<int>(sizeof(K2aParams)); }
// the launch geometry at N stages and M obstacle slots (Layout): out[0] the
// team's lanes, out[1] the teams per block, out[2] the block's shared bytes,
// out[3] the workspace values per scenario
void k2a_launch_geometry(int N, int M, int* out) {
  const Layout lay = make_layout(N, M, K2A_NONU != 0, sizeof(Working));
  out[0] = TEAM;
  out[1] = TEAMS;
  out[2] = TEAMS * lay.team_bytes;
  out[3] = lay.ws;
}

// in: xs, us, dt, xf, u_prev, point and circle centers, radii, mask,
//     velocities, line endpoints, velocities, mask, polygon vertices, vertex
//     counts (int32), velocities, mask, lam_def, lam_term, mu_obs, mu_rate,
//     mu_box, mu_dt, mu_ball, rho, via points, via mask, the line-search
//     candidates (27 pointers)
// out: xs, us, dt, lam_def, lam_term, mu_obs, mu_rate, mu_box, mu_dt,
//      mu_ball, rho, cost, eq_norm, ineq_viol, converged (15 pointers)
// On the non-uniform grid (a K2A_NONU build, prm->nonu) dt is (B, N) and
// mu_dt (B, N, 2) in and out.
// ws: the workspace, B times k2a_launch_geometry's out[3] values of the
//     working type, scenario-major
// Launches this build's group (K2A_DOUBLE is the working type of every
// pointer); a launch of another model or objective family is refused.
int k2a_fused_solve(const K2aParams* prm, const void* const* in, void* const* out, void* ws,
                    int B, void* stream) {
  return launch<Working>(prm, in, out, ws, B, stream, nullptr);
}

// the blocks per SM of the instantiation a launch of prm would run, at its
// shared bytes (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks
int k2a_occupancy(const K2aParams* prm, int* blocks) {
  const void* none[27] = {};
  void* outs[15] = {};
  return launch<Working>(prm, none, outs, nullptr, 1, nullptr, blocks);
}

const char* k2a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
