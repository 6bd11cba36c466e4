// Kernel K1: the batched Riccati sweep, the KKT solve of every SQP iteration.
//
// Replaces the TPU kernel mpc_local_planner_tpu/ops/riccati_pallas.py ::
// _riccati_kernel and computes exactly what it computes, per scenario:
//   1. the backward sweep over the augmented z = [dx(3), du_prev(2), dtau]
//      (NA = 6, NU = 2), building Qzz, Qzu and Quu with reg on Quu's diagonal;
//   2. the closed-form 2x2 Quu inverse;
//   3. the symmetrized P update and the K/kff gain tape;
//   4. the dV accumulation;
//   5. the free-dtau initial stage (floored at the working type's tiny);
//   6. the forward rollout.
//
// Bound on an H100: bytes. Per scenario the sweep reads 114 values per stage
// (Fz 36, Gz 12, rz 6, Hzz 36, Hzu 12, Huu 4, hz 6, hu 2) plus PN, pN and
// reg once, and writes (N+1)*3 + N*2 + 2 values: at N = 30 in float that is
// 13,852 B in and 620 B out, 14,472 B per scenario, 59.3 MB for a batch of
// 4096, about 18 us at 3.35 TB/s. The arithmetic (~25 kFLOP per scenario at
// N = 30) is far below the card's rate. The TPU kernel read the stage data
// once into VMEM and kept the recursion, the tape and the rollout there.
//
// Design: every byte read once, by asynchronous bulk copies, into shared
// memory; the recursion on a team of lanes; the tape and the step on chip.
// - A block holds SPB consecutive scenarios, a team of TEAM lanes each, and
//   one producer warp. The producer copies the stage data into a ring of
//   SLOTS chunks of CHUNK stages in the order the backward sweep needs them
//   (stage N-1 first): each span's 16-byte interior by one TMA bulk copy
//   (cp.async.bulk) completing on the slot's full mbarrier, its head and
//   tail elements by cp.async tracked by the same barrier, so that any
//   element alignment of the inputs is taken (a span lands at its source's
//   address modulo 16). It refills a slot once the slot's empty barrier says
//   the teams are done with it, so later chunks are in flight while the
//   teams work on the current one. A horizon the ring holds whole is read
//   from device memory once; otherwise the rollout refills the ring with
//   Fz, Gz and rz of the chunks the sweep evicted (read last, so from L2 as
//   a rule).
// - Each stage's 6x8 products are spread over the team by column of
//   W = [Fz Gz]: lane c owns the columns c, c + TEAM, ... and forms
//   PW[:, c] = P W[:, c], the column Q[:, c] = H[:, c] + W' PW[:, c] and q_c;
//   the owners of the two control columns publish Quu, Qzu and qu in the
//   team's scratch; every lane then forms the 2x2 inverse and kff, the
//   owners of the state columns K[:, c] and the column c of Qzz + Qzu K, and
//   after a team barrier every lane reads the symmetrized P and p back into
//   its registers. The operands of the next stage are read ahead of each
//   barrier. dV, the free dtau and the rollout (z of 6) run on every lane
//   alike, without an exchange.
// - The gain tape (14 values per stage, at a stride of 16) stays in the
//   team's shared memory, in a workspace the wrapper allocates only where
//   the budget cannot hold it; the step is staged per chunk and each team
//   writes its scenario's dus and dxs out in contiguous runs.
// - make_geometry sets the chunk, the slots and the tape's place from (N,
//   working type) within a budget per scenario; the macros K1_TEAM, K1_SPB,
//   K1_CHUNK, K1_SLOTS and K1_SMEM_F32 set the design, measured on the card
//   by fused_probe.py k1, which builds other values. The kernel is templated
//   on float and double, so that the card can check the algorithm in f64,
//   free of f32 noise, and on the tape's place.
//
// A scenario past the batch in the last block copies nothing and writes only
// its own slice of the workspace; a lane's non-finite inputs stay on its own
// scenario, whose team alone reads them.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, allocates nothing, does not synchronize and returns
// cudaGetLastError() (0 on success).

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#ifndef K1_TEAM
#define K1_TEAM 8
#endif
#ifndef K1_SPB
#define K1_SPB 4
#endif
#ifndef K1_CHUNK
#define K1_CHUNK 4
#endif
#ifndef K1_SLOTS
#define K1_SLOTS 2
#endif
#ifndef K1_SMEM_F32
#define K1_SMEM_F32 6656
#endif

namespace {

constexpr int NA = 6;
constexpr int NU = 2;
constexpr int NX = 3;
constexpr int NW = NA + NU;         // the columns of W = [Fz Gz]
constexpr int TAPE = NU * NA + NU;  // one stage of the tape: K (2x6), kff (2)
constexpr int TAPE_STRIDE = 16;     // a stage's values in the tape: 16-byte loads
static_assert(TAPE <= TAPE_STRIDE, "a stage of the tape fits its stride");
constexpr int TEAM = K1_TEAM;       // lanes per scenario
constexpr int SPB = K1_SPB;         // scenarios per block
constexpr int CT = TEAM * SPB;           // the teams' threads
constexpr int CW = (CT + 31) / 32;        // their warps
constexpr int THREADS = CW * 32 + 32;     // and the producer warp, which issues the copies
constexpr int CPL = NW / TEAM;                // columns of W per lane
constexpr int MAX_SLOTS = 8;
constexpr int BAR_BYTES = 2 * 8 * MAX_SLOTS;  // each slot's full and empty barriers, at the front
constexpr int BLOCK_SMEM = 232448;  // the most dynamic shared memory of an H100 block
static_assert(TEAM == 1 || TEAM == 2 || TEAM == 4 || TEAM == 8, "a team divides 8 columns");
static_assert(THREADS <= 1024, "a block has at most 1024 threads");
static_assert(K1_SLOTS >= 1 && K1_SLOTS <= MAX_SLOTS, "the ring has 1 to 8 slots");
static_assert(K1_CHUNK >= 1, "a chunk holds a stage at least");

// the stage inputs in the order of the arguments; the rollout's refills copy
// the first three (Fz, Gz, rz)
constexpr int NT = 8;
constexpr int NT_ROLLOUT = 3;
__host__ __device__ constexpr int width(int t) {
  return t == 0 ? NA * NA : t == 1 ? NA * NU : t == 2 ? NA : t == 3 ? NA * NA
       : t == 4 ? NA * NU : t == 5 ? NU * NU : t == 6 ? NA : NU;
}
enum { T_FZ, T_GZ, T_RZ, T_HZZ, T_HZU, T_HUU, T_HZ, T_HU };
// width(t) for a run-time t on the card: one indexed constant load
__constant__ int kWidth[NT] = {NA * NA, NA * NU, NA, NA * NA, NA * NU, NU * NU, NA, NU};

// a team's scratch, each part at a multiple of 16 bytes: VT (the P update
// before its symmetrization, transposed: row c is its column c, 36), X (the
// control columns of Q, 2 x 8, then qu, 2, and 2 of padding), p (6, padded
// to 8)
constexpr int S_V = 0;
constexpr int S_X = S_V + NA * NA;
constexpr int X_LEN = NU * NW + NU + 2;
constexpr int S_P = S_X + X_LEN;
constexpr int SCRATCH = S_P + 8;
static_assert(S_X % 4 == 0 && S_P % 4 == 0, "16-byte parts in float");

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny<double>() { return DBL_MIN; }
// 1 / x rounded to nearest, as the division 1 / x rounds it
__device__ __forceinline__ float recip(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double recip(double x) { return __drcp_rn(x); }

// N values from p, a multiple of 16 bytes, in 16-byte loads
template <typename T, int N>
__device__ __forceinline__ void load16(const T* p, T (&out)[N]) {
  if constexpr (sizeof(T) == 4) {
    static_assert(N % 4 == 0, "whole 16-byte loads");
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x;
      out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z;
      out[4 * i + 3] = v.w;
    }
  } else {
    static_assert(N % 2 == 0, "whole 16-byte loads");
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const double2 v = reinterpret_cast<const double2*>(p)[i];
      out[2 * i] = v.x;
      out[2 * i + 1] = v.y;
    }
  }
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }
// an odd multiple of 16: the teams of a warp then start their areas in
// different banks
__host__ __device__ constexpr int odd16(int x) { return (round16(x) / 16) % 2 ? round16(x) : round16(x) + 16; }

// The launch geometry, in bytes of the block's dynamic shared memory:
// [the ring's barriers: full, empty]
// [SPB times a team's fixed area: scratch | staged step | tape]
// [SLOTS times: SPB times a scenario's chunk: one region per input tensor]
struct Geometry {
  int chunk, slots, tape_ws;
  int fixed, ost_off, tape_off;  // a team's fixed area and its parts
  int scen_slot, region[NT];     // a scenario's chunk in a slot and its regions
  int scen_bytes, shared_bytes;  // per scenario, per block
};

Geometry fill(int N, int es, int C, int S, int tape_ws) {
  Geometry g{};
  g.chunk = C;
  g.slots = S;
  g.tape_ws = tape_ws;
  int off = round16(SCRATCH * es);
  g.ost_off = off;
  off += round16(C * (NU + NX) * es);
  g.tape_off = off;
  if (!tape_ws) off += round16(N * TAPE_STRIDE * es);
  g.fixed = odd16(off);
  int roff = 0;
  for (int t = 0; t < NT; ++t) {
    g.region[t] = roff;
    roff += round16(C * width(t) * es) + 16;  // room to land at the source's offset mod 16
  }
  g.scen_slot = odd16(roff);
  g.scen_bytes = g.fixed + S * g.scen_slot;
  g.shared_bytes = BAR_BYTES + SPB * g.scen_bytes;
  return g;
}

// Within the budget per scenario (K1_SMEM_F32 in float, twice in double, at
// most a block's share): the chunk of K1_CHUNK stages and the most slots up
// to K1_SLOTS with the tape in shared memory; then fewer slots (two at
// least); then the tape in the workspace; then half the chunk.
Geometry make_geometry(int N, int es) {
  const int share = (BLOCK_SMEM - BAR_BYTES) / SPB;
  const int budget = K1_SMEM_F32 / 4 * es < share ? K1_SMEM_F32 / 4 * es : share;
  int C = N < K1_CHUNK ? N : K1_CHUNK;
  for (;;) {
    const int nq = (N + C - 1) / C;
    const int s_hi = nq < K1_SLOTS ? nq : K1_SLOTS;
    const int s_lo = s_hi < 2 ? s_hi : 2;
    for (int tape_ws = 0; tape_ws < 2; ++tape_ws) {
      for (int S = s_hi; S >= s_lo; --S) {
        const Geometry g = fill(N, es, C, S, tape_ws);
        if (g.scen_bytes <= budget || (C == 1 && tape_ws == 1 && S == s_lo)) return g;
      }
    }
    C = (C + 1) / 2;
  }
}

template <typename T>
struct Args {
  const T* in[NT];  // Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu
  const T* PN;
  const T* pN;
  const T* reg;
  T* dxs;
  T* dus;
  T* dtau;
  T* dv;
  T* tape;  // the workspace: blocks * SPB scenarios of N * TAPE_STRIDE (a slice past the batch too), or unused
  int B, N, free_tau;
  int vec;  // Fz and Gz start at multiples of 16 bytes: their rows in 16-byte loads
};

// ---- asynchronous copies into shared memory ------------------------------ //

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// a barrier that `count` threads arrive at once per phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// an arrival with the bytes the arriving lane's bulk copies bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// the phase does not complete before this lane's earlier cp.async have
__device__ __forceinline__ void mbar_track_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// a TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// one element (4 or 8 bytes) by the lane: a span's head and tail
template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// where a chunk's span of input t lands in a scenario's chunk area: at the
// source's address modulo 16
template <typename T>
__device__ __forceinline__ const T* span_src(const Args<T>& a, int t, int b, int k0) {
  return a.in[t] + (static_cast<size_t>(b) * a.N + k0) * kWidth[t];
}
template <typename T>
__device__ __forceinline__ T* span_dst(unsigned char* area, const Geometry& g, int t, const T* src) {
  return reinterpret_cast<T*>(area + g.region[t] + (reinterpret_cast<uintptr_t>(src) & 15));
}

// A span of `len` bytes from src: the bytes before its first 16-byte
// boundary (head), the 16-byte interior (body) and the rest (tail).
struct Span {
  int head, body, tail;
};
__device__ __forceinline__ Span split(const void* src, int len) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = mis == 0 ? 0 : (16 - mis < len ? 16 - mis : len);
  const int body = (len - head) & ~15;
  return {head, body, len - head - body};
}

// The ring's schedule: visits 0 .. nq-1 are the backward sweep's chunks
// (nq-1 first), each into slot v % S; visits nq .. 2nq-1 the rollout's
// chunks (0 first). The rollout finds chunks 0 .. S-1 where the sweep left
// them; a chunk f >= S is refilled (Fz, Gz, rz) into the slot of chunk f - S
// once that one is done. A slot's last visit before it is refilled frees it
// (its empty barrier): backward visit v if v + S < nq, rollout chunk f if
// f + S < nq; every load after the first S waits for that.
__device__ __forceinline__ int rollout_slot(int f, int nq, int S) { return (nq - 1 - f % S) % S; }
// whether visit v loads a chunk, and which one (q), into which slot, how many inputs
__device__ __forceinline__ bool visit_load(int v, int nq, int S, int* q, int* slot, int* nt) {
  if (v < nq) {
    *q = nq - 1 - v;
    *slot = v % S;
    *nt = NT;
    return true;
  }
  if (v < 2 * nq && v - nq >= S) {
    *q = v - nq;
    *slot = rollout_slot(v - nq, nq, S);
    *nt = NT_ROLLOUT;
    return true;
  }
  return false;
}

// The producer warp's copies of visit v: the first nt inputs of chunk q
// (stages [q*C, q*C + n)) of the block's live scenarios into their areas of
// the slot. The spans are dealt round the warp's lanes (span i: scenario
// i / NT, input i % NT); each lane copies its spans' head and tail elements
// by cp.async (tracked by the slot's full barrier), arrives on the full
// barrier with the bytes of their 16-byte interiors, then copies each
// interior by one TMA bulk copy onto it.
template <typename T>
__device__ void issue_visit(const Args<T>& a, const Geometry& g, unsigned char* ring,
                            uint64_t* full, int pl, int q, int slot, int nt, int b0) {
  const int k0 = q * g.chunk;
  const int n = a.N - k0 < g.chunk ? a.N - k0 : g.chunk;
  const int live_s = a.B - b0 < SPB ? a.B - b0 : SPB;
  const int spans = live_s * NT;
  unsigned bytes = 0;
  for (int i = pl; i < spans; i += 32) {
    const int s = i / NT, t = i % NT;
    if (t >= nt) continue;
    const T* src = span_src(a, t, b0 + s, k0);
    char* d8 = reinterpret_cast<char*>(span_dst(ring + (slot * SPB + s) * g.scen_slot, g, t, src));
    const char* s8 = reinterpret_cast<const char*>(src);
    const Span sp = split(src, n * kWidth[t] * static_cast<int>(sizeof(T)));
    bytes += sp.body;
    for (int o = 0; o < sp.head; o += static_cast<int>(sizeof(T)))
      cp_async_small<sizeof(T)>(d8 + o, s8 + o);
    for (int o = sp.head + sp.body; o < sp.head + sp.body + sp.tail; o += static_cast<int>(sizeof(T)))
      cp_async_small<sizeof(T)>(d8 + o, s8 + o);
  }
  mbar_track_cp_async(&full[slot]);
  mbar_expect(&full[slot], bytes);
  for (int i = pl; i < spans; i += 32) {
    const int s = i / NT, t = i % NT;
    if (t >= nt) continue;
    const T* src = span_src(a, t, b0 + s, k0);
    char* d8 = reinterpret_cast<char*>(span_dst(ring + (slot * SPB + s) * g.scen_slot, g, t, src));
    const Span sp = split(src, n * kWidth[t] * static_cast<int>(sizeof(T)));
    if (sp.body)
      bulk_copy(d8 + sp.head, reinterpret_cast<const char*>(src) + sp.head, sp.body, &full[slot]);
  }
}

// The producer warp: every loading visit in order, each refill after the
// slot's empty barrier says its last visit is done.
template <typename T>
__device__ void producer(const Args<T>& a, const Geometry& g, unsigned char* ring, uint64_t* full,
                         uint64_t* empty, int pl, int nq, int b0) {
  unsigned phases = 0;
  for (int v = 0; v < 2 * nq; ++v) {
    int q, slot, nt;
    if (!visit_load(v, nq, g.slots, &q, &slot, &nt)) continue;
    if (v >= g.slots) {
      mbar_wait(&empty[slot], (phases >> slot) & 1u);
      phases ^= 1u << slot;
    }
    issue_visit(a, g, ring, full, pl, q, slot, nt, b0);
  }
  cp_async_wait_all();  // its element copies land before the lane exits
}

// ---- the kernel ---------------------------------------------------------- //

// One stage's operands of a lane's columns c of W, read ahead of the stage:
// W[:, c], H[:, c] (without reg), h_c, and rz.
template <typename T>
struct StageIn {
  T w[CPL][NA], hcol[CPL][NW], hc[CPL], r[NA];
};

// Where a lane's columns c of W sit in a chunk: W[:, c] (stride ws), H[:, c]
// = [Hzz[:, c]; Hzu[c, :]'] for a state column, [Hzu[:, u]; Huu[:, u]] for
// control column u (strides ws and us), h_c, each with its step per stage.
template <typename T>
struct Columns {
  const T* w[CPL];
  const T* h[CPL];
  const T* hu[CPL];
  const T* hc[CPL];
  const T* r;
  int ws[CPL], us[CPL], wstep[CPL], hustep[CPL], hcstep[CPL];
};

template <typename T>
__device__ __forceinline__ Columns<T> columns(const T* const* base, int lane) {
  Columns<T> cl;
  cl.r = base[T_RZ];
#pragma unroll
  for (int m = 0; m < CPL; ++m) {
    const int c = lane + m * TEAM;
    const bool zc = c < NA;
    cl.w[m] = zc ? base[T_FZ] + c : base[T_GZ] + (c - NA);
    cl.h[m] = zc ? base[T_HZZ] + c : base[T_HZU] + (c - NA);
    cl.hu[m] = zc ? base[T_HZU] + c * NU : base[T_HUU] + (c - NA);
    cl.hc[m] = zc ? base[T_HZ] + c : base[T_HU] + (c - NA);
    cl.ws[m] = zc ? NA : NU;
    cl.us[m] = zc ? 1 : NU;
    cl.wstep[m] = zc ? NA * NA : NA * NU;  // Fz and Hzz, or Gz and Hzu
    cl.hustep[m] = zc ? NA * NU : NU * NU;
    cl.hcstep[m] = zc ? NA : NU;
  }
  return cl;
}

template <typename T>
__device__ __forceinline__ void load_stage(StageIn<T>& in, const Columns<T>& cl, int kk) {
#pragma unroll
  for (int i = 0; i < NA; ++i) in.r[i] = cl.r[kk * NA + i];
#pragma unroll
  for (int m = 0; m < CPL; ++m) {
    const T* w = cl.w[m] + kk * cl.wstep[m];
    const T* h = cl.h[m] + kk * cl.wstep[m];
    const T* hu = cl.hu[m] + kk * cl.hustep[m];
#pragma unroll
    for (int l = 0; l < NA; ++l) {
      in.w[m][l] = w[l * cl.ws[m]];
      in.hcol[m][l] = h[l * cl.ws[m]];
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) in.hcol[m][NA + u] = hu[u * cl.us[m]];
    in.hc[m] = cl.hc[m][kk * cl.hcstep[m]];
  }
}

// WS: the tape in the workspace (device memory), else in the team's shared
// memory
template <typename T, bool WS>
__global__ void __launch_bounds__(THREADS) riccati_sweep_kernel(const Args<T> a, const Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int team = static_cast<int>(threadIdx.x) / TEAM;
  const int lane = static_cast<int>(threadIdx.x) % TEAM;
  const int b0 = static_cast<int>(blockIdx.x) * SPB;
  const int b = b0 + team;
  const bool live = b < a.B;
  const int N = a.N, C = g.chunk, S = g.slots;
  const int nq = (N + C - 1) / C;
  // every team of a warp runs the same barriers: one warp-wide mask (the
  // teams' lanes in this warp) keeps the warp converged
  const int warp_lanes = CT - static_cast<int>(threadIdx.x) / 32 * 32;
  const unsigned warp_mask = warp_lanes >= 32 ? 0xffffffffu : (1u << warp_lanes) - 1u;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // a slot's chunk has landed
  uint64_t* empty = full + MAX_SLOTS;                   // a slot's last visit is done
  unsigned phases = 0;
  unsigned char* fixed = smem + BAR_BYTES + team * g.fixed;
  T* sc = reinterpret_cast<T*>(fixed);
  T* ost = reinterpret_cast<T*>(fixed + g.ost_off);  // the chunk's dus, then its dxs rows
  T* tp;
  if constexpr (WS)
    tp = a.tape + static_cast<size_t>(b) * N * TAPE_STRIDE;
  else
    tp = reinterpret_cast<T*>(fixed + g.tape_off);
  unsigned char* ring = smem + BAR_BYTES + SPB * g.fixed;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], CT);
    }
  }
  __syncthreads();
  if (threadIdx.x >= CW * 32) {
    producer(a, g, ring, full, empty, static_cast<int>(threadIdx.x) - CW * 32, nq, b0);
    return;
  }
  if (threadIdx.x >= CT) return;  // the idle lanes of the last teams' warp

  T P[NA][NA], p[NA];
  T regv = T(0);
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    p[i] = live ? a.pN[static_cast<size_t>(b) * NA + i] : T(0);
#pragma unroll
    for (int j = 0; j < NA; ++j)
      P[i][j] = live ? a.PN[static_cast<size_t>(b) * NA * NA + i * NA + j] : T(0);
  }
  if (live) regv = a.reg[b];
  T dv = T(0);

  // ---- backward sweep ---------------------------------------------------- //
  for (int v = 0; v < nq; ++v) {
    mbar_wait(&full[v % S], (phases >> (v % S)) & 1u);
    phases ^= 1u << (v % S);
    const int q = nq - 1 - v, k0 = q * C;
    const int k1 = k0 + C < N ? k0 + C : N;
    unsigned char* area = ring + ((v % S) * SPB + team) * g.scen_slot;
    const T* base[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) base[t] = span_dst(area, g, t, span_src(a, t, b, k0));

    const Columns<T> cl = columns(base, lane);
    StageIn<T> in;
    load_stage(in, cl, k1 - 1 - k0);
    for (int k = k1 - 1; k >= k0; --k) {
      const int kk = k - k0;
      const T* F = base[T_FZ] + kk * NA * NA;
      const T* G = base[T_GZ] + kk * NA * NU;

      // this lane's columns c of W: y = P W[:, c] (= PW[:, c]) and
      // q_c = h_c + W[:, c]' (P r + p) = h_c + y' r + W[:, c]' p (P symmetric)
      T y[CPL][NA], Qc[CPL][NW], qc[CPL];
#pragma unroll
      for (int m = 0; m < CPL; ++m) {
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          T acc = T(0);
#pragma unroll
          for (int l = 0; l < NA; ++l) acc += P[i][l] * in.w[m][l];
          y[m][i] = acc;
        }
        T yr = T(0), wp = T(0);
#pragma unroll
        for (int l = 0; l < NA; ++l) {
          yr += y[m][l] * in.r[l];
          wp += in.w[m][l] * p[l];
        }
        qc[m] = in.hc[m] + (yr + wp);
#pragma unroll
        for (int j = 0; j < NW; ++j) Qc[m][j] = T(0);
      }
      // Q[:, c] = H[:, c] + W' y: every lane reads all of W, two rows at a time
#pragma unroll
      for (int l2 = 0; l2 < NA; l2 += 2) {
        T f[2 * NA], gg[2 * NU];
        if (a.vec) {
          load16(F + l2 * NA, f);
          load16(G + l2 * NU, gg);
        } else {
#pragma unroll
          for (int j = 0; j < 2 * NA; ++j) f[j] = F[l2 * NA + j];
#pragma unroll
          for (int j = 0; j < 2 * NU; ++j) gg[j] = G[l2 * NU + j];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int m = 0; m < CPL; ++m) {
#pragma unroll
            for (int j = 0; j < NA; ++j) Qc[m][j] += f[h * NA + j] * y[m][l2 + h];
#pragma unroll
            for (int j = 0; j < NU; ++j) Qc[m][NA + j] += gg[h * NU + j] * y[m][l2 + h];
          }
        }
      }
#pragma unroll
      for (int m = 0; m < CPL; ++m) {
        const int c = lane + m * TEAM;
#pragma unroll
        for (int j = 0; j < NW; ++j)
          Qc[m][j] = in.hcol[m][j] + Qc[m][j] + (c == j && c >= NA ? regv : T(0));
        if (c >= NA) {
          T* X = sc + S_X + (c - NA) * NW;
#pragma unroll
          for (int j = 0; j < NW; ++j) X[j] = Qc[m][j];
          sc[S_X + NU * NW + (c - NA)] = qc[m];
        }
      }
      if (k > k0) load_stage(in, cl, kk - 1);  // the next stage's, ahead of the barrier
      __syncwarp(warp_mask);

      // Quu, qu, Qzu from the control columns' owners
      T X[X_LEN];
      load16(sc + S_X, X);
      const T Quu00 = X[NA], Quu10 = X[NA + 1];
      const T Quu01 = X[NW + NA], Quu11 = X[NW + NA + 1];
      const T qu0 = X[NU * NW], qu1 = X[NU * NW + 1];
      // closed-form 2x2 inverse of Quu; kff = -Quu^-1 qu
      const T inv_det = recip(Quu00 * Quu11 - Quu01 * Quu10);
      const T Qi[NU][NU] = {{Quu11 * inv_det, -Quu01 * inv_det},
                            {-Quu10 * inv_det, Quu00 * inv_det}};
      const T kf[NU] = {-(Qi[0][0] * qu0 + Qi[0][1] * qu1), -(Qi[1][0] * qu0 + Qi[1][1] * qu1)};
      T* tk = tp + static_cast<size_t>(k) * TAPE_STRIDE;
#pragma unroll
      for (int m = 0; m < CPL; ++m) {
        const int c = lane + m * TEAM;
        if (c < NA) {
          // K[:, c] = -Quu^-1 Quz[:, c]; the column c of Qzz + Qzu K into
          // row c of VT; p_c
          T Kc[NU];
#pragma unroll
          for (int r2 = 0; r2 < NU; ++r2)
            Kc[r2] = -(Qi[r2][0] * Qc[m][NA] + Qi[r2][1] * Qc[m][NA + 1]);
#pragma unroll
          for (int i = 0; i < NA; ++i)
            sc[S_V + c * NA + i] = Qc[m][i] + (X[i] * Kc[0] + X[NW + i] * Kc[1]);
          sc[S_P + c] = qc[m] + (sc[S_X + c] * kf[0] + sc[S_X + NW + c] * kf[1]);
#pragma unroll
          for (int r2 = 0; r2 < NU; ++r2) tk[r2 * NA + c] = Kc[r2];
        }
      }
      if (lane == 0) {
        tk[NU * NA] = kf[0];
        tk[NU * NA + 1] = kf[1];
      }
      dv -= T(0.5) * (qu0 * kf[0] + qu1 * kf[1]);
      __syncwarp(warp_mask);

      // P <- 0.5 (V + V'), p, on every lane
      T vt[NA * NA], pv[8];
      load16(sc + S_V, vt);
      load16(sc + S_P, pv);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        p[i] = pv[i];
#pragma unroll
        for (int l = i; l < NA; ++l) {
          // V[i][l] = vt[l][i]
          const T s2 = T(0.5) * (vt[l * NA + i] + vt[i * NA + l]);
          P[i][l] = s2;
          P[l][i] = s2;
        }
      }
    }
    if (v + S < nq) mbar_arrive(&empty[v % S]);
  }

  // ---- initial stage: free dtau minimization ------------------------------ //
  const T Ptau = P[NA - 1][NA - 1] + regv;
  // max(Ptau, tiny) that keeps a NaN (fmax would drop it)
  const T den = Ptau < tiny<T>() ? tiny<T>() : Ptau;
  const T dtau = a.free_tau ? -p[NA - 1] / den : T(0);
  const T dv_tau = a.free_tau ? T(0.5) * Ptau * dtau * dtau : T(0);
  if (live && lane == 0) {
    a.dtau[b] = dtau;
    a.dv[b] = dv + dv_tau;
  }
  for (int i = lane; live && i < NX; i += TEAM) a.dxs[static_cast<size_t>(b) * (N + 1) * NX + i] = T(0);

  // ---- forward rollout ---------------------------------------------------- //
  // every lane of the team carries z alone (no exchange): u = K z + kff,
  // z <- Fz z + Gz u + rz; lane 0 stages the step
  T z[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) z[i] = T(0);
  z[NA - 1] = dtau;
  for (int f = 0; f < nq; ++f) {
    const int fs = rollout_slot(f, nq, S);
    if (f >= S) {  // a refill
      mbar_wait(&full[fs], (phases >> fs) & 1u);
      phases ^= 1u << fs;
    }
    const int k0 = f * C;
    const int k1 = k0 + C < N ? k0 + C : N;
    unsigned char* area = ring + (fs * SPB + team) * g.scen_slot;
    const T* Fb = span_dst(area, g, T_FZ, span_src(a, T_FZ, b, k0));
    const T* Gb = span_dst(area, g, T_GZ, span_src(a, T_GZ, b, k0));
    const T* rb = span_dst(area, g, T_RZ, span_src(a, T_RZ, b, k0));
    for (int k = k0; k < k1; ++k) {
      const int kk = k - k0;
      T Kt[TAPE_STRIDE], Fk[NA * NA], Gk[NA * NU];
      load16(tp + static_cast<size_t>(k) * TAPE_STRIDE, Kt);
      if (a.vec) {
        load16(Fb + kk * NA * NA, Fk);
        load16(Gb + kk * NA * NU, Gk);
      } else {
#pragma unroll
        for (int j = 0; j < NA * NA; ++j) Fk[j] = Fb[kk * NA * NA + j];
#pragma unroll
        for (int j = 0; j < NA * NU; ++j) Gk[j] = Gb[kk * NA * NU + j];
      }
      T u[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NA; ++j) acc += Kt[i * NA + j] * z[j];
        u[i] = acc + Kt[NU * NA + i];
      }
      T zn[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NA; ++j) acc += Fk[i * NA + j] * z[j];
        T accu = T(0);
#pragma unroll
        for (int l = 0; l < NU; ++l) accu += Gk[i * NU + l] * u[l];
        zn[i] = acc + accu + rb[kk * NA + i];
      }
#pragma unroll
      for (int i = 0; i < NA; ++i) z[i] = zn[i];
      if (lane == 0) {
        ost[kk * NU] = u[0];
        ost[kk * NU + 1] = u[1];
#pragma unroll
        for (int i = 0; i < NX; ++i) ost[C * NU + kk * NX + i] = zn[i];
      }
    }
    if (f + S < nq) mbar_arrive(&empty[fs]);
    // the chunk's step, by the team: its scenario's dus and dxs rows one run each
    __syncwarp(warp_mask);
    const int n = k1 - k0;
    if (live) {
      for (int e = lane; e < n * NU; e += TEAM) a.dus[(static_cast<size_t>(b) * N + k0) * NU + e] = ost[e];
      for (int e = lane; e < n * NX; e += TEAM)
        a.dxs[(static_cast<size_t>(b) * (N + 1) + k0 + 1) * NX + e] = ost[C * NU + e];
    }
    __syncwarp(warp_mask);
  }
}

template <typename T>
int launch(const T* Fz, const T* Gz, const T* rz, const T* Hzz, const T* Hzu,
           const T* Huu, const T* hz, const T* hu, const T* PN, const T* pN,
           const T* reg, T* dxs, T* dus, T* dtau, T* dv, T* tape, int B, int N,
           int free_tau, void* stream, int* occupancy) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = make_geometry(N, static_cast<int>(sizeof(T)));
  if (g.tape_ws && tape == nullptr && occupancy == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = g.tape_ws ? riccati_sweep_kernel<T, true> : riccati_sweep_kernel<T, false>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.shared_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occupancy)
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, THREADS, g.shared_bytes));
  const int vec = ((reinterpret_cast<uintptr_t>(Fz) | reinterpret_cast<uintptr_t>(Gz)) & 15) == 0;
  const Args<T> a{{Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu}, PN, pN, reg, dxs, dus, dtau, dv, tape,
                  B, N, free_tau, vec};
  const int blocks = (B + SPB - 1) / SPB;
  kernel<<<blocks, THREADS, g.shared_bytes, static_cast<cudaStream_t>(stream)>>>(a, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// values of the workspace (the gain tape: K, kff, 2 of padding) per
// scenario and stage
int riccati_sweep_tape_per_stage() { return TAPE_STRIDE; }

// the design this library was built with: out[0] TEAM, out[1] SPB,
// out[2] K1_CHUNK, out[3] K1_SLOTS, out[4] K1_SMEM_F32
void riccati_sweep_design(int* out) {
  out[0] = TEAM;
  out[1] = SPB;
  out[2] = K1_CHUNK;
  out[3] = K1_SLOTS;
  out[4] = K1_SMEM_F32;
}

// the launch geometry at N stages in float (is_double = 0) or double:
// out[0] the team's lanes, out[1] the scenarios per block, out[2] the chunk's
// stages, out[3] the ring's slots, out[4] the block's shared bytes, out[5]
// the workspace's values per scenario (0: the tape in shared memory)
void riccati_sweep_launch_geometry(int N, int is_double, int* out) {
  const Geometry g = make_geometry(N, is_double ? 8 : 4);
  out[0] = TEAM;
  out[1] = SPB;
  out[2] = g.chunk;
  out[3] = g.slots;
  out[4] = g.shared_bytes;
  out[5] = g.tape_ws ? N * TAPE_STRIDE : 0;
}

// the blocks per SM of the launch at N stages (the CUDA occupancy
// calculator at its shared bytes) into *blocks
int riccati_sweep_occupancy(int N, int is_double, int* blocks) {
  if (is_double)
    return launch<double>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          1, N, 0, nullptr, blocks);
  return launch<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                       nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1,
                       N, 0, nullptr, blocks);
}

// tape: the workspace, (B rounded up to the scenarios per block) times
// riccati_sweep_launch_geometry's out[5] values; ignored when that is 0
int riccati_sweep_f32(const float* Fz, const float* Gz, const float* rz,
                      const float* Hzz, const float* Hzu, const float* Huu,
                      const float* hz, const float* hu, const float* PN,
                      const float* pN, const float* reg, float* dxs, float* dus,
                      float* dtau, float* dv, float* tape, int B, int N, int free_tau,
                      void* stream) {
  return launch<float>(Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN, reg, dxs, dus,
                       dtau, dv, tape, B, N, free_tau, stream, nullptr);
}

int riccati_sweep_f64(const double* Fz, const double* Gz, const double* rz,
                      const double* Hzz, const double* Hzu, const double* Huu,
                      const double* hz, const double* hu, const double* PN,
                      const double* pN, const double* reg, double* dxs,
                      double* dus, double* dtau, double* dv, double* tape, int B,
                      int N, int free_tau, void* stream) {
  return launch<double>(Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN, reg, dxs, dus,
                        dtau, dv, tape, B, N, free_tau, stream, nullptr);
}

const char* riccati_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
