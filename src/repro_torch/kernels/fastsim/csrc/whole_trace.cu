// The Scenario API's compiled whole-trace simulation core (engine="jax"):
// the colocated heartbeat loop of a fixed, inert-KV aladdin/jsq fleet over a
// whole trace, in one launch.
//
// Replaces the reference's jit core, src/repro/serving/fastsim_jax.py:185
// (`_make_simulate`: one `lax.while_loop` over beats, the per-worker advance
// vmapped across the fleet and the whole simulation vmapped across candidate
// fleet sizes for `optimize`).
//
// What bounds it: neither bytes nor operations. The trace is read once and
// the four outputs written once (a few MB at 10^5 requests: about a
// microsecond at 3.35 TB/s), and the arithmetic is a few fp64 operations a
// member a decode iteration. The loop is sequential by nature: beats
// follow each other, within a beat each queued request is placed after the
// one before it against the aggregates that placement changed, and a
// lane's segments are a chain of dependent fp64 adds. So the kernel is
// bound by latency: loop iterations x (admission + the placement pass's
// tries and commits + the slowest warp's advance + two block barriers).
// On the `scale` slice (3,108 iterations, one placement a try) the phases
// are of one size: the tries, the commits (each a CPython hypot and a
// division), the aggregates after a finish (the same hypot), the advance
// and the barriers; on the day (87,830 iterations of
// ~5 beats) the advance and aggregates come first (chip_smoke.py's
// `[fastsim whole split]`).
//
// Design, and what each part does about it:
// - one CTA per candidate fleet size (the reference's vmap), all candidates
//   in parallel on the SMs; `n_active[c]` workers of the W lanes are alive;
// - up to 16 warps, lane w on warp w % 16, at 128 registers a thread (no
//   spill where the lane state is in shared memory; the global-memory
//   instantiations spill up to ~110 B): at 1024 threads (a warp a lane up
//   to 32 lanes) the 64-register cap spills and the kernel ran slower.
//   Best fit packs the requests onto the first lanes, so the lanes a warp
//   shares with lane w + 16 are mostly idle;
// - a lane's members are kept compact, in placement order (request id,
//   l_in, l_real, l_out, t_decode_spent, first token, the weight l_in +
//   gamma * l_real and the raw ATGT budget: 48 B a member, and 16 B a
//   batch size in the lane's tables), in dynamic shared memory beside the
//   lanes (156 B each) where they fit, up to about 3,000 slots (W x B);
//   past that in a global scratch per candidate, through the same base
//   pointers. Placement appends; a finish compacts the survivors in order.
//   Those that started prefilling are a prefix: a prefill starts every new
//   member, and placements come after it. So no slot flags, no free-slot
//   search, and the weighted context is summed in the numpy core's order
//   (every member in placement order) by one chain of adds over the list;
// - each lane caches what placement and the advance read: members, new
//   members and their prompt tokens, the ongoing members' context and the
//   fewest tokens any of them has left, the weighted context, its capacity
//   norm (CPython's hypot, computed once a change, not once a try) and the
//   untagged constraint (b) bound theta * budget at one more member, from
//   per-lane tables over the batch sizes. A decode segment that the beat
//   end cuts changes the context by k * b and the fewest tokens left by -k,
//   exact integers; only a placement, a prefill or a finish changes the
//   rest, and only a finish needs the lane's reductions (one butterfly for
//   the context sum and the least tokens left; the weighted context and
//   the strictest budget at the end of the advance). Constraint (d)'s
//   budget over the ongoing members moves with every segment: each walk
//   over the members keeps each thread's share of it, reduced once at the
//   end of an advance that walked;
// - warp 0 admits arrivals from a window of kArr arrivals staged in shared
//   memory with what placement reads of them (32 at a time by ballot),
//   keeps the backlog in rank order by a parallel merge of the new
//   arrivals' keys (rank << 32 | id, unique) between two queue buffers
//   (EDF only), and runs the placement pass over the queue staged in shared
//   memory kStage requests at a time (a queue that fits one stage stays
//   staged from pass to pass, so the main path reads no global memory to
//   place): one thread a lane tests constraints (a)-(d) against the cached
//   values, one ballot tells whether any lane passes, and two 32-bit max
//   reductions and a ballot give the lane of the largest capacity norm
//   (aladdin) or smallest batch (jsq), ties to the lowest index as
//   jnp.argmax/argmin. The lane's owning thread commits. Within a pass
//   lanes only fill, so an untagged aladdin request no larger (weight,
//   prompt) than one that found no lane stays queued without a round
//   (exact while gamma, theta and every live lane's c2 and k1 are >= 0,
//   which the kernel checks), and once a jsq request finds no lane none
//   does. The pass needs no block barrier between tries; the other warps
//   wait at the one barrier before the advance;
// - the beat clock, the event skip and the beat count are warp 0's and
//   thread 0's; each iteration ends on a barrier that also reduces whether
//   any lane is busy. One synchronisation with the host, at the end, when
//   the outputs are read;
// - optional counters (`stats`, ops.py's WHOLE_STATS), in a second
//   instantiation of the kernel so that the main path's carries none:
//   thread 0 adds the SM cycles of each phase, each warp those of its
//   lanes' advance and aggregates (the slowest warp's count), and the
//   counts.
//
// Declined: a thread-block cluster per candidate. It would spread a single
// candidate's lanes over more SMs, but every iteration's two barriers
// would become cluster barriers, and the advance is not the phase that
// sets the slice's pace.
//
// Numerics are those of the numpy core, which is bit for bit equal to the
// reference engine: every add and multiply through __dadd_rn/__dmul_rn (nvcc
// never contracts those into a fused multiply-add), sequential
// left-associated sums of floats in the numpy core's order (a worker's
// weighted context over its members in placement order), `k2*C + c2*b + c3`
// as ((k2*C) + (c2*b)) + c3, a decode segment closed at every beat end (also
// at those the event skip covers), and the capacity norm through CPython's
// math.hypot algorithm (`py_hypot`, fp64.cuh), so best-fit ranks workers as
// the numpy core does. Integer sums (batch, context, new tokens) are exact
// in any order.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "fp64.cuh"
#include "launch.cuh"

namespace {

using namespace repro::fastsim;

constexpr int kMaxWarps = 16;     // 128 registers a thread, no spill
constexpr int kMaxSmem = 232448;  // what a CTA may use on Hopper
constexpr int kStage = 256;       // queued requests staged at a time
constexpr int kArr = 512;         // arrivals staged at a time
constexpr int kFront = 4;         // requests that found no lane, kept

// the optional per-candidate counters, in the order of ops.py's WHOLE_STATS
enum { S_CYCLES, S_ADMIT, S_TRY, S_COMMIT, S_ADVANCE, S_AGG, S_BARRIER,
       S_ITERS, S_BEATS, S_TRIED, S_PLACED, S_PREFILLS, S_DECODES,
       S_DECODE_ITERS, S_RECOUNTS, S_DOMINATED, NSTAT };

__device__ __forceinline__ void count(long long* stat, int k, long long v) {
  if (stat)
    atomicAdd(reinterpret_cast<unsigned long long*>(&stat[k]),
              static_cast<unsigned long long>(v));
}

struct Params {
  const double* arrival;
  const int64_t* l_in;
  const int64_t* l_real;
  const int64_t* rank;
  const double* ttft_r;
  const double* atgt_r;
  const int64_t* n_active;
  const double* par;  // (8, W): k1, c1, k2, c2, c3, maxb_norm, cmax_norm, maxb
  int64_t* out_lo;    // (C, n)
  double* out_f;      // (3, C, n): t_decode_spent, first token, finish
  int64_t* beats;     // (C,)
  unsigned char* scratch;  // (C, scratch_bytes): a candidate's two buffers
  size_t scratch_bytes;    // of queue keys (n each), then the lane state
                           // that shared memory does not hold (kWhere)
  long long* stats;        // (C, NSTAT) or null
  int n, W, B, C;
  double hb, horizon, theta, gamma, ttft, atgt;
  int aladdin, edf, tagged;
};

// A candidate's lane state: per lane (W entries each) and per member (W x
// B, lane-major, a lane's members compact in placement order), reached from
// two base pointers, the lanes' and the members', so that few registers
// hold them. Both are in the CTA's dynamic shared memory where they fit
// (`IN_SHARED`); else the members and tables are in the candidate's global
// scratch (`MEMBERS_GLOBAL`), and where not even the lanes fit, all of it.
// Each is an instantiation of the kernel, so that the compiler knows each
// pointer's memory space and shared memory is reached by its own loads and
// stores (a choice made at run time makes every access generic, and the
// kernel slower).
// Lanes: the clock, coefficients, capacity-norm denominators, the weighted
// context, its capacity norm, theta * budget at one more member, the
// decode budgets over the ongoing members (untagged, tagged), the
// strictest member budgets; the ongoing members' context (l_in + l_out)
// and the new members' prompt tokens; members, new members (the list's
// tail), the fewest tokens an ongoing member has left (max(l_real - l_out,
// 1)) and the same for the new ones once they prefill, the max batch.
// Members: t_decode_spent, first token, weight l_in + gamma * l_real, raw
// ATGT budget; request id, l_in, l_real, l_out. Tables (B + 1 entries a
// lane): the untagged constraint (b) bound theta * max(((atgt - c3) -
// c2*(b + 1)) / k2, 0) and the capacity norm's first term b / max_batch,
// for every batch b, so that a change of members divides only for the
// weighted context's term.
enum { LD_T, LD_K1, LD_C1, LD_K2, LD_C2, LD_C3, LD_MBN, LD_CMN, LD_WCTX,
       LD_NORM, LD_CAP, LD_DBUD, LD_DBUD_T, LD_AMIN, LD_TMIN, NLD };
enum { MD_TDS, MD_TF1, MD_V, MD_AR, NMD };
enum { TD_CAP, TD_BATCH, NTD };
enum { LL_C0, LL_NEWSUM, NLL };
enum { LI_CNT, LI_NNEW, LI_NFIN, LI_NFIN_NEW, LI_MAXB, NLI };
enum { MI_RID, MI_LI, MI_LR, MI_LO, NMI };

enum { IN_SHARED, MEMBERS_GLOBAL, ALL_GLOBAL };

struct Lanes {
  double* d;     // (NLD, W) lane doubles
  long long* l;  // (NLL, W)
  int* i;        // (NLI, W)
  double* md;    // (NMD, W * B) member doubles, then (NTD, W, B + 1) tables
  int* mi;       // (NMI, W * B)
  int W, wb, tb;

  // the lanes' bytes, rounded up so that the members may follow them
  __host__ __device__ static size_t lane_bytes(int W) {
    const size_t w = W;
    return (8 * (NLD + NLL) * w + 4 * NLI * w + 15) &
           ~static_cast<size_t>(15);
  }
  __host__ __device__ static size_t member_bytes(int W, int B) {
    const size_t w = W, wb = w * B;
    return 8 * (NMD * wb + NTD * (wb + w)) + 4 * NMI * wb;
  }
  __device__ Lanes(unsigned char* lanes, unsigned char* members, int W_,
                   int B)
      : W(W_), wb(W_ * B), tb(B + 1) {
    d = reinterpret_cast<double*>(lanes);
    l = reinterpret_cast<long long*>(d + NLD * W);
    i = reinterpret_cast<int*>(l + NLL * W);
    md = reinterpret_cast<double*>(members);
    mi = reinterpret_cast<int*>(md + NMD * wb + NTD * W * tb);
  }
  __device__ double& f(int k, int w) const { return d[k * W + w]; }
  __device__ double& mf(int k, int x) const { return md[k * wb + x]; }
  __device__ double& tab(int k, int w, int b) const {
    return md[NMD * wb + (k * W + w) * tb + b];
  }
  __device__ long long& ll(int k, int w) const { return l[k * W + w]; }
  __device__ int& n(int k, int w) const { return i[k * W + w]; }
  __device__ int& mn(int k, int x) const { return mi[k * wb + x]; }
};

// A window of kArr arrivals from `base` on, with what the placement pass
// reads of each: arrival time, l_in, l_real, weight, raw budgets, and the
// EDF key (rank << 32 | id). The queued requests staged for a placement
// pass, kStage at a time, with the same values.
struct Window {
  double arr[kArr], v[kArr], ar[kArr], tr[kArr];
  long long key[kArr];
  int li[kArr], lr[kArr];
};
struct Stage {
  double v[kStage], ar[kStage], tr[kStage];
  long long key[kStage];
  int li[kStage], lr[kStage];
};

// Room for the kernel's static shared memory: the window, the stage and a
// few hundred bytes of scalars and counters.
constexpr size_t kStaticSmem = sizeof(Window) + sizeof(Stage) + 1024;
constexpr size_t kSmemFree = kMaxSmem - kStaticSmem;

// Lane w's constraint (b) budget at batch b, max(((a - c3) - c2*b) / k2,
// 0), or inf where k2 <= 0.
__device__ __forceinline__ double budget(const Lanes& L, int w, double a,
                                         int b) {
  const double k2 = L.f(LD_K2, w);
  return k2 > 0.0 ? max0(dvd(sub(sub(a, L.f(LD_C3, w)),
                                 mul(L.f(LD_C2, w), static_cast<double>(b))),
                             k2))
                  : CUDART_INF;
}

// Lane w's cached untagged constraint (b) bound and capacity norm, from the
// tables and its weighted context; both change only with its members or
// its weighted context (one thread).
__device__ __forceinline__ void lane_cache(const Lanes& L, int w) {
  const int cnt = L.n(LI_CNT, w);
  L.f(LD_CAP, w) = L.tab(TD_CAP, w, cnt);
  L.f(LD_NORM, w) = py_hypot(L.tab(TD_BATCH, w, cnt),
                             dvd(L.f(LD_WCTX, w), L.f(LD_CMN, w)));
}

// Warp 0: the window of arrivals from `base` on (past the trace: never).
__device__ __forceinline__ void fill_window(const Params& p, Window& A,
                                            int base, int lane, bool tag_a) {
  for (int k = lane; k < kArr; k += 32) {
    const int j = base + k;
    if (j < p.n) {
      const long long li = p.l_in[j], lr = p.l_real[j];
      A.arr[k] = p.arrival[j];
      A.li[k] = static_cast<int>(li);
      A.lr[k] = static_cast<int>(lr);
      A.v[k] = add(static_cast<double>(li),
                   mul(p.gamma, static_cast<double>(lr)));
      A.ar[k] = tag_a ? p.atgt_r[j] : CUDART_INF;
      A.tr[k] = tag_a ? p.ttft_r[j] : CUDART_INF;
      A.key[k] = p.edf ? (static_cast<long long>(p.rank[j]) << 32) | j : j;
    } else {
      A.arr[k] = CUDART_INF;
    }
  }
  __syncwarp();
}

// Warp 0, EDF: merge the new keys q[q0, qlen) into the rank-ordered backlog
// q[0, q0), into the other buffer when they do not simply follow it.
// Returns the queue's buffer.
__device__ __forceinline__ long long* merge_edf(long long* q,
                                                long long* q_other, int q0,
                                                int qlen, int lane) {
  // do the new keys ascend and follow the backlog?
  bool in_order = true;
  for (int i = q0 + lane; i < qlen; i += 32)
    in_order = in_order && (i == 0 || q[i - 1] < q[i]);
  if (__all_sync(kFull, in_order)) return q;
  // each key's place: its rank among the new keys plus the backlog's keys
  // below it (binary search; keys are unique), or its backlog index plus
  // the new keys below it
  for (int i = q0 + lane; i < qlen; i += 32) {
    const long long key = q[i];
    int r = 0;
    for (int u = q0; u < qlen; ++u) r += q[u] < key;
    int lo = 0, hi = q0;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (q[mid] < key) lo = mid + 1; else hi = mid;
    }
    q_other[r + lo] = key;
  }
  for (int j = lane; j < q0; j += 32) {
    const long long key = q[j];
    int r = 0;
    for (int u = q0; u < qlen; ++u) r += q[u] < key;
    q_other[j + r] = key;
  }
  __syncwarp();
  return q_other;
}

// Warp 0: admit the arrivals <= t into the queue q (their keys) from the
// staged window, refilled as idx passes it; while the queue is `resident`
// (it fits in the stage, no EDF) the stage gets their values too. For EDF,
// merge the new keys into the rank-ordered backlog. Returns the queue's
// buffer.
__device__ __forceinline__ long long* admit(
    const Params& p, double t, int lane, bool tag_a, int& idx, int& qlen,
    int& abase, bool& resident, Window& A, Stage& S, long long* q,
    long long* q_other) {
  const int n = p.n, q0 = qlen;
  for (;;) {
    if (idx >= n) break;
    if (idx >= abase + kArr) {
      abase = idx;
      fill_window(p, A, abase, lane, tag_a);
    }
    const int k = idx - abase + lane;
    const bool in = k < kArr && A.arr[k] <= t;
    const int c = __popc(__ballot_sync(kFull, in));  // a prefix: sorted
    resident = resident && qlen + c <= kStage;
    if (lane < c) {
      q[qlen + lane] = A.key[k];
      if (resident) {
        const int x = qlen + lane;
        S.key[x] = A.key[k];
        S.li[x] = A.li[k];
        S.lr[x] = A.lr[k];
        S.v[x] = A.v[k];
        S.ar[x] = A.ar[k];
        S.tr[x] = A.tr[k];
      }
    }
    idx += c;
    qlen += c;
    if (c < 32 && idx < abase + kArr) break;
  }
  __syncwarp();
  return p.edf && qlen > q0 ? merge_edf(q, q_other, q0, qlen, lane) : q;
}

// The placement pass over the backlog q[0, qlen) (warp 0). Returns the
// number still queued; they keep their order at the head of q, and, when
// the queue fit in one stage, at the head of the stage (`resident`).
__device__ __forceinline__ int place_pass(const Params& p, const Lanes& L,
                                          Stage& S, long long* q, int qlen,
                                          bool& resident, long long na,
                                          int lane, bool tag_a, bool mono,
                                          long long* stat) {
  const int W = p.W, B = p.B;
  const bool al = p.aladdin;
  const bool prune = al && mono;
  double front_v[kFront];
  int front_l[kFront];
  int nfront = 0, slot_f = 0;
  bool full = false;  // jsq: a request found no lane, so none will
  int keep = 0;
  // the pass's own split (thread 0, lane 0 here): each try's round over the
  // lanes, each commit
  long long mark = stat && lane == 0 ? clock64() : 0;
  auto lap = [&](int k) {
    if (stat && lane == 0) {
      const long long now = clock64();
      stat[k] += now - mark;
      mark = now;
    }
  };
  for (int base = 0; base < qlen; base += kStage) {
    const int nb = qlen - base < kStage ? qlen - base : kStage;
    if (!resident || base > 0) {
      __syncwarp();
      for (int k = lane; k < nb; k += 32) {
        const long long key = q[base + k];
        const int r = static_cast<int>(key & 0xffffffffLL);
        const long long liv = p.l_in[r], lrv = p.l_real[r];
        S.key[k] = key;
        S.li[k] = static_cast<int>(liv);
        S.lr[k] = static_cast<int>(lrv);
        S.v[k] = add(static_cast<double>(liv),
                     mul(p.gamma, static_cast<double>(lrv)));
        S.ar[k] = tag_a ? p.atgt_r[r] : CUDART_INF;
        S.tr[k] = tag_a ? p.ttft_r[r] : CUDART_INF;
      }
    }
    __syncwarp();
    unsigned kept = 0;  // lane k % 32's bit k / 32: the stage's k stays
    for (int k = 0; k < nb; ++k) {
      const int liv = S.li[k];
      const double v = S.v[k], ar = S.ar[k];
      const bool ct = tag_a && ar != CUDART_INF;
      if (stat && lane == 0) stat[S_TRIED] += 1;
      bool dom = full;
      if (prune && !ct) {
#pragma unroll
        for (int u = 0; u < kFront; ++u)
          dom = dom || (u < nfront && v >= front_v[u] && liv >= front_l[u]);
      }
      // this thread's lanes lane, lane + 32, ...: the first that passes
      // with the largest key (the capacity norm's bits, non-negative, or
      // the complement of the batch for jsq)
      int bi = -1;
      unsigned long long bk = 0;
      for (int x = lane; x < W && !dom; x += 32) {
        const int cnt = L.n(LI_CNT, x);
        if (!(x < na && cnt + 1 <= L.n(LI_MAXB, x))) continue;
        unsigned long long kx;
        if (al) {
          double cap = L.f(LD_CAP, x), t_eff = p.ttft;
          double d_eff = L.f(LD_DBUD, x);
          if (ct) {  // an untagged candidate takes the scalar branch
            const double tr = S.tr[k];
            const double a0 = pmin(L.f(LD_AMIN, x), ar);
            const double a_eff = a0 == CUDART_INF ? p.atgt : a0;
            const double t0 = pmin(L.f(LD_TMIN, x), tr);
            t_eff = t0 == CUDART_INF ? p.ttft : t0;
            d_eff = L.f(LD_DBUD_T, x);
            cap = mul(p.theta, budget(L, x, a_eff, cnt + 1));
          }
          const double pre_t = add(
              mul(L.f(LD_K1, x),
                  static_cast<double>(L.ll(LL_NEWSUM, x) + liv)),
              L.f(LD_C1, x));
          if (!(add(L.f(LD_WCTX, x), v) <= cap && pre_t <= t_eff &&
                pre_t <= d_eff))
            continue;
          kx = static_cast<unsigned long long>(
              __double_as_longlong(L.f(LD_NORM, x)));
        } else {
          kx = 0xffffffffull - static_cast<unsigned>(cnt);
        }
        if (bi < 0 || kx > bk) {
          bi = x;
          bk = kx;
        }
      }
      if (!__any_sync(kFull, bi >= 0)) {  // stays queued, FIFO order kept
        if (lane == 0) {
          q[keep] = S.key[k];
          if (stat && dom) stat[S_DOMINATED] += 1;
        }
        if (lane == (k & 31)) kept |= 1u << (k >> 5);
        ++keep;
        if (prune && !ct && !dom) {
#pragma unroll
          for (int u = 0; u < kFront; ++u) {
            if (u == slot_f) {
              front_v[u] = v;
              front_l[u] = liv;
            }
          }
          nfront = nfront < kFront ? nfront + 1 : kFront;
          slot_f = slot_f + 1 < kFront ? slot_f + 1 : 0;
        }
        full = !al;
        lap(S_TRY);
      } else {
        // the largest key over the warp, high word then low word; among
        // the threads that hold it, the lowest lane index
        const bool has = bi >= 0;
        const unsigned hi = has ? static_cast<unsigned>(bk >> 32) : 0u;
        const unsigned mh = __reduce_max_sync(kFull, hi);
        const unsigned lo = has && hi == mh ? static_cast<unsigned>(bk) : 0u;
        const unsigned ml = __reduce_max_sync(kFull, lo);
        const bool cand = has && hi == mh && lo == ml;
        int w = -1;
        for (int r = 0; w < 0; ++r) {
          const unsigned m = __ballot_sync(kFull, cand && (bi >> 5) == r);
          if (m) w = 32 * r + __ffs(m) - 1;
        }
        lap(S_TRY);
        if (lane == (w & 31)) {  // the lane's owner commits
          const int pos = L.n(LI_CNT, w);
          const int x = w * B + pos;
          const int lrv = S.lr[k];
          L.mn(MI_RID, x) = static_cast<int>(S.key[k] & 0xffffffffLL);
          L.mn(MI_LI, x) = liv;
          L.mn(MI_LR, x) = lrv;
          L.mn(MI_LO, x) = 0;
          L.mf(MD_TDS, x) = 0.0;
          L.mf(MD_TF1, x) = CUDART_NAN;
          L.mf(MD_V, x) = v;
          L.mf(MD_AR, x) = ar;
          L.n(LI_CNT, w) = pos + 1;
          L.n(LI_NNEW, w) += 1;
          L.ll(LL_NEWSUM, w) += liv;
          const int left = lrv - 1 > 1 ? lrv - 1 : 1;
          if (left < L.n(LI_NFIN_NEW, w)) L.n(LI_NFIN_NEW, w) = left;
          L.f(LD_WCTX, w) = add(L.f(LD_WCTX, w), v);
          if (tag_a) {
            L.f(LD_AMIN, w) = pmin(L.f(LD_AMIN, w), ar);
            L.f(LD_TMIN, w) = pmin(L.f(LD_TMIN, w), S.tr[k]);
          }
          if (al) lane_cache(L, w);
        }
        if (stat && lane == 0) stat[S_PLACED] += 1;
        lap(S_COMMIT);
      }
    }
    // a single stage: compact the kept requests' values to its head, so
    // the next pass finds them staged
    if (!p.edf && qlen <= kStage) {
      __syncwarp();
      int m = 0;
      for (int c0 = 0; c0 < nb; c0 += 32) {
        const int k = c0 + lane;
        const bool kp = k < nb && ((kept >> (c0 >> 5)) & 1u);
        const unsigned mask = __ballot_sync(kFull, kp);
        double v = 0.0, ar = 0.0, tr = 0.0;
        long long key = 0;
        int li = 0, lr = 0;
        if (kp) {
          v = S.v[k];
          ar = S.ar[k];
          tr = S.tr[k];
          key = S.key[k];
          li = S.li[k];
          lr = S.lr[k];
        }
        __syncwarp();
        if (kp) {
          const int y = m + __popc(mask & ((1u << lane) - 1u));
          S.v[y] = v;
          S.ar[y] = ar;
          S.tr[y] = tr;
          S.key[y] = key;
          S.li[y] = li;
          S.lr[y] = lr;
        }
        m += __popc(mask);
        __syncwarp();
      }
    }
  }
  __syncwarp();
  resident = !p.edf && qlen <= kStage;
  return keep;
}

// Lane w through the k_steps beats that end at t + hb, t + hb + hb, ...,
// t_next (warp-wide). Each beat is the worker's advance_to(beat end): a
// joint prefill of the new members (decode stalls), else a decode segment
// with the batch fixed until the next finish or the beat end. Finishers are
// written out at once and the survivors compacted. Returns the number of
// the last beat in which a request finished (0 for none). `agg` gathers
// the cycles of the lane's aggregates (a finish's compaction and
// reductions, the closing reductions) when counting.
__device__ __forceinline__ int advance_lane(
    const Params& p, const Lanes& L, int w, int lane, double t, int k_steps,
    double t_next, bool tag_a, int64_t* out_lo, double* out_tds,
    double* out_tf1, double* out_tfn, long long* stat, long long& agg) {
  const int o = w * p.B;
  const double k1 = L.f(LD_K1, w), c1 = L.f(LD_C1, w), k2 = L.f(LD_K2, w),
               c2 = L.f(LD_C2, w), c3 = L.f(LD_C3, w);
  const double atgt = p.atgt;
  double tl = L.f(LD_T, w);
  int cnt = L.n(LI_CNT, w), nnew = L.n(LI_NNEW, w), nfin = L.n(LI_NFIN, w);
  long long c0 = L.ll(LL_C0, w);
  // this thread's share of constraint (d)'s budgets over the ongoing
  // members, as of the last walk over them
  double slack = CUDART_INF, slack_t = CUDART_INF;
  bool walked = false, finished = false;
  int j_fin = 0, n_pre = 0, n_dec = 0;
  long long n_it = 0;
  double bj = t;
  for (int j = 1; j <= k_steps; ++j) {
    bj = add(bj, p.hb);
    bool fin = false;
    while (tl < bj) {
      if (nnew > 0) {  // joint prefill of the new members
        const long long newsum = L.ll(LL_NEWSUM, w);
        const double dur_p = add(mul(k1, static_cast<double>(newsum)), c1);
        const double t_pre = add(tl, dur_p);
        const int b = cnt - nnew;
        slack = slack_t = CUDART_INF;
        for (int s = lane; s < cnt; s += 32) {
          const int x = o + s;
          double tds = 0.0;
          int m = 0;
          if (s < b) {
            tds = add(L.mf(MD_TDS, x), dur_p);
            L.mf(MD_TDS, x) = tds;
            m = L.mn(MI_LO, x) - 1;
          } else {  // new members have no decode time yet
            L.mf(MD_TF1, x) = t_pre;
            L.mn(MI_LO, x) = 1;
          }
          const double md = static_cast<double>(m > 0 ? m : 0);
          slack = pmin(slack, sub(mul(atgt, md), tds));
          if (tag_a) {
            const double ar = L.mf(MD_AR, x);
            slack_t = pmin(slack_t,
                           sub(mul(ar == CUDART_INF ? atgt : ar, md), tds));
          }
        }
        c0 += newsum + nnew;
        const int nf = L.n(LI_NFIN_NEW, w);
        nfin = nf < nfin ? nf : nfin;
        nnew = 0;
        tl = t_pre;
        walked = true;
        ++n_pre;
        __syncwarp();
        if (lane == 0) {
          L.ll(LL_NEWSUM, w) = 0;
          L.n(LI_NFIN_NEW, w) = INT32_MAX;
          if (tag_a) L.f(LD_TMIN, w) = CUDART_INF;  // none is new
        }
        continue;
      }
      if (cnt == 0) {
        tl = bj;
        continue;
      }
      // a decode segment: the batch is fixed until the next finish or the
      // beat end; the context c0 + k * b is an exact integer in a double
      const double cb = mul(c2, static_cast<double>(cnt));
      const double db = static_cast<double>(cnt);
      double ck = static_cast<double>(c0);
      int k = 0;
      double td = tl, seg = 0.0;
      while (k < nfin && td < bj) {
        const double dur = add(add(mul(k2, ck), cb), c3);
        ++k;
        ck += db;
        td = add(td, dur);
        seg = add(seg, dur);
      }
      ++n_dec;
      n_it += k;
      walked = true;
      tl = td;
      if (k < nfin) {  // cut by the beat end: nobody finishes
        slack = slack_t = CUDART_INF;
        for (int s = lane; s < cnt; s += 32) {
          const int x = o + s;
          const int lo = L.mn(MI_LO, x) + k;
          const double tds = add(L.mf(MD_TDS, x), seg);
          L.mn(MI_LO, x) = lo;
          L.mf(MD_TDS, x) = tds;
          const double md = static_cast<double>(lo - 1);
          slack = pmin(slack, sub(mul(atgt, md), tds));
          if (tag_a) {
            const double ar = L.mf(MD_AR, x);
            slack_t = pmin(slack_t,
                           sub(mul(ar == CUDART_INF ? atgt : ar, md), tds));
          }
        }
        c0 += static_cast<long long>(k) * cnt;
        nfin -= k;
        continue;
      }
      // someone finishes: write the finishers out, compact the survivors
      // in order, and recount the context and the fewest tokens left
      const long long a0 = stat ? clock64() : 0;
      int m = 0, least = INT32_MAX;
      long long ctx = 0;
      slack = slack_t = CUDART_INF;
      for (int s0 = 0; s0 < cnt; s0 += 32) {
        const int s = s0 + lane;
        const int x = o + s;
        int lo = 0, li = 0, lr = 0, r = 0;
        double tds = 0.0, tf1 = 0.0, v = 0.0, ar = 0.0;
        bool keep = false;
        if (s < cnt) {
          lo = L.mn(MI_LO, x) + k;
          lr = L.mn(MI_LR, x);
          tds = add(L.mf(MD_TDS, x), seg);
          tf1 = L.mf(MD_TF1, x);
          r = L.mn(MI_RID, x);
          if (lo >= lr) {
            out_lo[r] = lo;
            out_tds[r] = tds;
            out_tf1[r] = tf1;
            out_tfn[r] = td;
          } else {
            keep = true;
            li = L.mn(MI_LI, x);
            v = L.mf(MD_V, x);
            ar = L.mf(MD_AR, x);
          }
        }
        const unsigned mask = __ballot_sync(kFull, keep);
        __syncwarp();
        if (keep) {
          const int y = o + m + __popc(mask & ((1u << lane) - 1u));
          L.mn(MI_RID, y) = r;
          L.mn(MI_LI, y) = li;
          L.mn(MI_LR, y) = lr;
          L.mn(MI_LO, y) = lo;
          L.mf(MD_TDS, y) = tds;
          L.mf(MD_TF1, y) = tf1;
          L.mf(MD_V, y) = v;
          L.mf(MD_AR, y) = ar;
          ctx += li + lo;
          least = lr - lo < least ? lr - lo : least;
          const double md = static_cast<double>(lo - 1);
          slack = pmin(slack, sub(mul(atgt, md), tds));
          if (tag_a)
            slack_t = pmin(slack_t,
                           sub(mul(ar == CUDART_INF ? atgt : ar, md), tds));
        }
        m += __popc(mask);
        __syncwarp();
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ctx += __shfl_xor_sync(kFull, ctx, off);
        const int l2 = __shfl_xor_sync(kFull, least, off);
        least = l2 < least ? l2 : least;
      }
      cnt = m;
      c0 = ctx;
      nfin = least;  // survivors have 1 or more tokens left
      fin = true;
      finished = true;
      if (stat) agg += clock64() - a0;
    }
    if (fin) j_fin = j;
    if (cnt == 0) {  // idle: jump to the last beat end
      tl = t_next > tl ? t_next : tl;
      break;
    }
  }
  // the lane's aggregates for the next placement pass: the decode budgets
  // over the ongoing members when a walk moved them; after a finish the
  // weighted context (one chain of adds over the members in placement
  // order), the strictest ATGT budget and the cached bound and norm
  const long long a1 = stat ? clock64() : 0;
  if (walked) {
    double amin = CUDART_INF;
    if (finished && tag_a)
      for (int s = lane; s < cnt; s += 32)
        amin = pmin(amin, L.mf(MD_AR, o + s));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      slack = pmin(slack, __shfl_xor_sync(kFull, slack, off));
      if (tag_a) {
        slack_t = pmin(slack_t, __shfl_xor_sync(kFull, slack_t, off));
        amin = pmin(amin, __shfl_xor_sync(kFull, amin, off));
      }
    }
    if (lane == 0) {
      L.f(LD_DBUD, w) = mul(p.theta, max0(slack));
      L.f(LD_DBUD_T, w) = mul(p.theta, max0(slack_t));
      if (finished) {
        double wctx = 0.0;
#pragma unroll 4
        for (int s = 0; s < cnt; ++s) wctx = add(wctx, L.mf(MD_V, o + s));
        L.f(LD_WCTX, w) = wctx;
        if (tag_a) L.f(LD_AMIN, w) = amin;
      }
    }
  }
  if (lane == 0) {
    L.f(LD_T, w) = tl;
    L.n(LI_CNT, w) = cnt;
    L.n(LI_NNEW, w) = nnew;
    L.n(LI_NFIN, w) = nfin;
    L.ll(LL_C0, w) = c0;
    if (finished && p.aladdin) lane_cache(L, w);
    if (stat) {
      count(stat, S_PREFILLS, n_pre);
      count(stat, S_DECODES, n_dec);
      count(stat, S_DECODE_ITERS, n_it);
      count(stat, S_RECOUNTS, finished);
    }
  }
  __syncwarp();
  if (stat) agg += clock64() - a1;
  return j_fin;
}

// kStats: the counters on (a second instantiation, so the main path's
// code carries none of them); kWhere: where the lane state lives
template <bool kStats, int kWhere>
__global__ void __launch_bounds__(kMaxWarps * 32)
    whole_trace_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Window s_win;
  __shared__ Stage s_stage;
  __shared__ double s_tnext;
  __shared__ int s_idx, s_qlen, s_ksteps, s_jmax;
  __shared__ long long s_stat[NSTAT];
  __shared__ long long s_wadv[kMaxWarps], s_wagg[kMaxWarps];

  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int n = p.n, W = p.W;
  const size_t cn = static_cast<size_t>(c) * n;
  const size_t Cn = static_cast<size_t>(p.C) * n;
  int64_t* out_lo = p.out_lo + cn;
  double* out_tds = p.out_f + cn;
  double* out_tf1 = p.out_f + Cn + cn;
  double* out_tfn = p.out_f + 2 * Cn + cn;
  unsigned char* const scr = p.scratch + c * p.scratch_bytes;
  long long* const q_base = reinterpret_cast<long long*>(scr);
  long long* q = q_base;  // warp 0's: the queue's buffer
  const long long na = p.n_active[c];
  const bool tag_a = p.tagged && p.aladdin;
  unsigned char* const glob = scr + 16 * static_cast<size_t>(n);
  unsigned char* const lanes = kWhere == ALL_GLOBAL ? glob : smem;
  const Lanes L(lanes,
                kWhere == MEMBERS_GLOBAL ? glob
                                         : lanes + Lanes::lane_bytes(W),
                W, p.B);
  // the counters: thread 0 adds the cycles of each phase of an iteration;
  // each warp times its lanes' advance and aggregates, of which the slowest
  // warp's count
  long long* const stat = kStats ? s_stat : nullptr;
  const long long t_begin = clock64();
  long long mark = t_begin;
  auto lap = [&](int k) {
    if (stat && tid == 0) {
      const long long now = clock64();
      stat[k] += now - mark;
      mark = now;
    }
  };

  for (int i = tid; i < n; i += blockDim.x) {
    out_lo[i] = 0;
    out_tds[i] = 0.0;
    out_tf1[i] = CUDART_NAN;
    out_tfn[i] = CUDART_NAN;
  }
  for (int w = tid; w < W; w += blockDim.x) {
    L.f(LD_T, w) = 0.0;
    L.f(LD_K1, w) = p.par[w];
    L.f(LD_C1, w) = p.par[W + w];
    L.f(LD_K2, w) = p.par[2 * W + w];
    L.f(LD_C2, w) = p.par[3 * W + w];
    L.f(LD_C3, w) = p.par[4 * W + w];
    L.f(LD_MBN, w) = p.par[5 * W + w];
    L.f(LD_CMN, w) = p.par[6 * W + w];
    L.n(LI_MAXB, w) = static_cast<int>(p.par[7 * W + w]);
    L.f(LD_WCTX, w) = 0.0;
    // an empty lane's budgets, as a reduction over no members gives them
    L.f(LD_DBUD, w) = L.f(LD_DBUD_T, w) = mul(p.theta, max0(CUDART_INF));
    L.f(LD_AMIN, w) = L.f(LD_TMIN, w) = CUDART_INF;
    L.ll(LL_C0, w) = L.ll(LL_NEWSUM, w) = 0;
    L.n(LI_CNT, w) = L.n(LI_NNEW, w) = 0;
    L.n(LI_NFIN, w) = L.n(LI_NFIN_NEW, w) = INT32_MAX;
  }
  __syncthreads();  // the tables read every lane's coefficients
  for (int k = tid; k < W * (p.B + 1); k += blockDim.x) {
    const int w = k / (p.B + 1), b = k % (p.B + 1);
    L.tab(TD_CAP, w, b) = mul(p.theta, budget(L, w, p.atgt, b + 1));
    L.tab(TD_BATCH, w, b) = dvd(static_cast<double>(b), L.f(LD_MBN, w));
  }
  __syncthreads();
  if (p.aladdin)
    for (int w = tid; w < W; w += blockDim.x) lane_cache(L, w);
  bool mono = false;  // warp 0's
  if (warp == 0) {
    // constraints (a)-(d) only tighten as a lane fills (the placement
    // pass's pruning): no negative weight, decode slope or prefill slope
    bool ok = true;
    for (int w = lane; w < W && w < na; w += 32)
      ok = ok && p.par[3 * W + w] >= 0.0 && p.par[w] >= 0.0;
    mono = __all_sync(kFull, ok) && p.gamma >= 0.0 && p.theta >= 0.0;
    fill_window(p, s_win, 0, lane, tag_a);
  }
  if (tid == 0) {
    for (int k = 0; k < NSTAT; ++k) s_stat[k] = 0;
    s_jmax = 0;
  }
  __syncthreads();
  if (tid == 0) mark = clock64();

  double t = 0.0;
  int idx = 0, qlen = 0, abase = 0;  // warp 0's idx, qlen; the others' copies
  bool any = false, resident = !p.edf;
  long long beats = 0;  // thread 0's
  for (;;) {
    if (!(t < p.horizon) || (idx >= n && qlen == 0 && !any)) break;
    if (warp == 0) {
      long long* const other = q == q_base ? q_base + n : q_base;
      q = admit(p, t, lane, tag_a, idx, qlen, abase, resident, s_win,
                s_stage, q, other);
      lap(S_ADMIT);
      qlen = place_pass(p, L, s_stage, q, qlen, resident, na, lane, tag_a,
                        mono, stat);
      if (tid == 0) mark = clock64();  // the pass timed its own laps
      if (lane == 0) {
        // event skip: with an empty queue, step the beat clock with the
        // same sequential adds up to the next arrival
        const bool can_skip = qlen == 0;
        const double next_arr =
            idx < n ? (idx < abase + kArr ? s_win.arr[idx - abase]
                                          : p.arrival[idx])
                    : CUDART_INF;
        int k = 0;
        double tt = t;
        while (tt < p.horizon && tt < next_arr && (k == 0 || can_skip)) {
          ++k;
          tt = add(tt, p.hb);
        }
        s_tnext = tt;
        s_ksteps = k;
        s_idx = idx;
        s_qlen = qlen;
      }
    }
    lap(S_BARRIER);
    const long long adv_begin = mark;
    __syncthreads();
    const double t_next = s_tnext;
    const int k_steps = s_ksteps;
    idx = s_idx;
    qlen = s_qlen;
    int jf = 0;
    bool busy = false;
    long long wadv = 0, wagg = 0;
    for (int w = warp; w < W; w += nw) {
      const long long c0 = stat ? clock64() : 0;
      long long agg = 0;
      const int j = advance_lane(p, L, w, lane, t, k_steps, t_next, tag_a,
                                 out_lo, out_tds, out_tf1, out_tfn, stat,
                                 agg);
      jf = j > jf ? j : jf;
      busy = busy || L.n(LI_CNT, w) > 0;
      if (stat) {
        wadv += clock64() - c0 - agg;
        wagg += agg;
      }
    }
    if (lane == 0) {
      if (jf > 0) atomicMax(&s_jmax, jf);
      if (stat) {
        s_wadv[warp] = wadv;
        s_wagg[warp] = wagg;
      }
    }
    any = __syncthreads_or(busy);
    // the final drain runs to the horizon: count its beats up to the one
    // in which the last request finished, where a stepwise loop stops
    if (tid == 0) {
      const int jmax = s_jmax;
      s_jmax = 0;  // read: the next advance writes it after a barrier
      const bool drained = idx >= n && !any;
      const int kb = drained && k_steps > 1 ? (jmax > 1 ? jmax : 1) : k_steps;
      beats += kb;
      if (stat) {
        // the phase between the barriers: the slowest warp's advance, the
        // slowest warp's advance and aggregates less that, and the rest is
        // waiting
        long long adv = 0, both = 0;
        for (int i = 0; i < nw; ++i) {
          adv = s_wadv[i] > adv ? s_wadv[i] : adv;
          both = s_wadv[i] + s_wagg[i] > both ? s_wadv[i] + s_wagg[i] : both;
        }
        const long long now = clock64();
        stat[S_ADVANCE] += adv;
        stat[S_AGG] += both - adv;
        stat[S_BARRIER] += (now - adv_begin) - both;
        mark = now;
        stat[S_ITERS] += 1;
        stat[S_BEATS] += kb;
      }
    }
    t = t_next;
  }
  // flush still-running members (partial clocks)
  for (int w = warp; w < W; w += nw) {
    const int o = w * p.B;
    for (int s = lane; s < L.n(LI_CNT, w); s += 32) {
      const int r = L.mn(MI_RID, o + s);
      out_lo[r] = L.mn(MI_LO, o + s);
      out_tds[r] = L.mf(MD_TDS, o + s);
      out_tf1[r] = L.mf(MD_TF1, o + s);
    }
  }
  if (tid == 0) p.beats[c] = beats;
  if (stat) {
    __syncthreads();
    if (tid == 0) {
      stat[S_CYCLES] = clock64() - t_begin;
      long long* out = p.stats + static_cast<size_t>(c) * NSTAT;
      for (int k = 0; k < NSTAT; ++k) out[k] += stat[k];
    }
  }
}

// Where a candidate's lane state goes (see Lanes), the dynamic shared
// memory it takes, and its global scratch after the queue's two buffers.
int lane_state_where(int W, int B) {
  const size_t lb = Lanes::lane_bytes(W);
  if (lb + Lanes::member_bytes(W, B) <= kSmemFree) return IN_SHARED;
  return lb <= kSmemFree ? MEMBERS_GLOBAL : ALL_GLOBAL;
}
size_t lane_state_smem(int W, int B, int where) {
  return where == IN_SHARED        ? Lanes::lane_bytes(W) +
                                         Lanes::member_bytes(W, B)
         : where == MEMBERS_GLOBAL ? Lanes::lane_bytes(W)
                                   : 0;
}
size_t scratch_bytes(int n, int W, int B, int where) {
  return 16 * static_cast<size_t>(n) +
         (where == IN_SHARED        ? 0
          : where == MEMBERS_GLOBAL ? Lanes::member_bytes(W, B)
                                    : Lanes::lane_bytes(W) +
                                          Lanes::member_bytes(W, B));
}
// the lane state's int offsets (up to NMD + NTD rows of W x (B + 1)
// entries) stay below 2**31
bool fits_int(int n, int W, int B) {
  return n >= 1 && W >= 1 && B >= 1 &&
         static_cast<long long>(W) * (B + 1) < (1LL << 28);
}

}  // namespace

extern "C" long long whole_trace_scratch_bytes(int n, int W, int B) {
  if (!fits_int(n, W, B)) return 0;
  return static_cast<long long>(
      scratch_bytes(n, W, B, lane_state_where(W, B)));
}

extern "C" int whole_trace_launch(
    const void* arrival, const void* l_in, const void* l_real,
    const void* rank, const void* ttft_r, const void* atgt_r,
    const void* n_active, const void* par, void* out_lo, void* out_f,
    void* beats, void* scratch, void* stats, int n, int W, int B, int C,
    double hb, double horizon, double theta, double gamma, double ttft,
    double atgt, int aladdin, int edf, int tagged, void* stream) {
  const int nw = W < kMaxWarps ? W : kMaxWarps;
  if (!fits_int(n, W, B) || C < 1 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int where = lane_state_where(W, B);
  const size_t bytes = lane_state_smem(W, B, where);
  Params p;
  p.arrival = static_cast<const double*>(arrival);
  p.l_in = static_cast<const int64_t*>(l_in);
  p.l_real = static_cast<const int64_t*>(l_real);
  p.rank = static_cast<const int64_t*>(rank);
  p.ttft_r = static_cast<const double*>(ttft_r);
  p.atgt_r = static_cast<const double*>(atgt_r);
  p.n_active = static_cast<const int64_t*>(n_active);
  p.par = static_cast<const double*>(par);
  p.out_lo = static_cast<int64_t*>(out_lo);
  p.out_f = static_cast<double*>(out_f);
  p.beats = static_cast<int64_t*>(beats);
  p.scratch = static_cast<unsigned char*>(scratch);
  p.scratch_bytes = scratch_bytes(n, W, B, where);
  p.stats = static_cast<long long*>(stats);
  p.n = n;
  p.W = W;
  p.B = B;
  p.C = C;
  p.hb = hb;
  p.horizon = horizon;
  p.theta = theta;
  p.gamma = gamma;
  p.ttft = ttft;
  p.atgt = atgt;
  p.aladdin = aladdin;
  p.edf = edf;
  p.tagged = tagged;
  using Kernel = void (*)(const Params);
  const Kernel kernels[2][3] = {
      {whole_trace_kernel<false, IN_SHARED>,
       whole_trace_kernel<false, MEMBERS_GLOBAL>,
       whole_trace_kernel<false, ALL_GLOBAL>},
      {whole_trace_kernel<true, IN_SHARED>,
       whole_trace_kernel<true, MEMBERS_GLOBAL>,
       whole_trace_kernel<true, ALL_GLOBAL>}};
  const Kernel kernel = kernels[stats != nullptr][where];
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<C, nw * 32, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
