// The Scenario API's chunked simulation core (engine="jax" outside the
// whole-trace envelope): up to K heartbeats of a fixed fleet configuration
// with live KV (constraint (e)'s peak admission, overflow eviction, FIFO
// resume), aladdin/jsq/po2 placement and lanes the host switches on, off or
// to draining between chunks.
//
// Replaces the reference's chunk kernel, src/repro/serving/fastsim_jax.py:608
// (`_make_chunk`: a `lax.while_loop` over beats whose body admits arrivals,
// runs the placement pass and vmaps `_advance_lane_kv`, :472, across the
// lanes; `run_policy_candidate_batch` vmaps the whole chunk across policy
// candidates).
//
// What bounds it: neither bytes nor operations. A chunk reads its packed
// state once and writes it once (about 0.9 MB at 128 lanes x 64 slots: a
// quarter of a microsecond at 3.35 TB/s), and its arithmetic is a few fp64
// operations a slot a decode iteration. Beats follow each other; within a
// beat each queued request is placed after the one before it, against the
// aggregates that placement changed, and a lane's prefill, eviction and
// decode segments are a chain of dependent steps. So the kernel is bound by
// latency: beats x (the backlog's tries, each a block barrier, + the
// placements' commits + the lanes' aggregates and advance, a warp a lane,
// 8 lanes a warp at 128 lanes). At 48 requests/s on 48-128 lanes a beat
// tries ~70 queued requests, of which ~10 find a lane, and a tested lane
// holds ~8-14 members of its 64 slots. The placement pass takes two
// thirds of a launch and the lanes' work a quarter (chip_smoke.py's
// `[fastsim chunk split]` counters).
//
// Design, and what each part does about it:
// - one CTA per candidate (the reference's vmap); the host cuts chunks at
//   every fleet change, so a chunk sees a fixed `mode` per lane (2 serving,
//   3 draining, 0 off);
// - the packed state is two flat buffers (float64 and int64) laid out as
//   `chunk_layout` in kernels/fastsim/ops.py (`Layout` below); the kernel
//   copies the input state to the output state and works there, so its
//   inputs stay as they were and the host can run a chunk again after it
//   grows the rows (slot exhaustion);
// - per-slot rows (13 arrays of W x B, 104 B a slot) stay in global memory,
//   where the L2 holds them; per-lane coefficients, clocks, the placement
//   pass's aggregates and each lane's counts of new, ongoing and preempted
//   rows live in dynamic shared memory (264 B a lane). The counts stand in
//   for every whole-state scan of a beat: occupancy, pending work and the
//   billing replay read W counts, not W x B slots;
// - a compact member list per serving lane, built once a placement pass
//   from the one walk over the lane's slots that gathers its aggregates:
//   the members' remaining tokens rem = max(l_real - l_out, 0) in
//   ascending order beside the suffix sums of their contexts l_in + l_out
//   in that order (as `kv_peak_arrays` forms them). The same build puts
//   the members' slots in the numpy core's join order (ongoing rows by
//   join sequence, then the new batch by placement sequence) in the warp's
//   scratch and sums the weighted context over them in one chain of adds.
//   Members are ranked by counting smaller keys among the members alone.
//   The lists (16 B a slot), the warps' scratch (24 B a slot), the staged
//   queue and the free-slot masks live in shared memory when W x B fits (W
//   128 x B 64 does), else in a global scratch per candidate that the
//   wrapper allocates at the size `fastsim_chunk_scratch_bytes` gives: the
//   same code with another base pointer;
// - constraint (e) in O(members), and mostly in O(1): the KV peak of a
//   lane's members plus the candidate is the larger of h*(sum ctx) +
//   j*(m + 1) and the term h*(S + count*k) + j*count at each threshold k, a
//   member's max(rem, 1) or the candidate's, where count and S are the
//   members with rem >= k (an index into the sorted list and its suffix
//   sum) plus the candidate if its rem >= k. All sums are integers, exact
//   in any order, and every term keeps kv_peak_arrays' expression, so the
//   test decides bit for bit as the walk over every slot that it replaces.
//   Before the walk over the list, one bound on every term (all contexts
//   plus the least of the rems' sum and (m + 1) times the largest rem)
//   settles the lanes far from their KV limit;
// - the placement pass runs on every thread, the queue staged in shared
//   memory: for each queued request one thread a lane tests constraints
//   (a)-(d) against cached aggregates (the capacity norm and the untagged
//   decode budget change only on the lane that takes a request) and (e) on
//   a lane that passes them, so every feasible lane is tested at once; one
//   barrier tells whether any lane can take it; warp 0 takes the lane that
//   comes first by norm (descending) and serving rank among those that
//   pass, which is the lane the numpy core's lazy best-fit walk accepts,
//   its first free slot from a bit mask, and inserts the request into the
//   lane's list in O(members). Within a pass lanes only fill, so an
//   untagged request no larger (weighted context, prompt) than one that
//   found no lane stays queued without a round (exact while no weight or
//   slope is negative, which the kernel checks). jsq and po2 keep their
//   kv_now admission, one thread a lane, and po2 its draw order;
// - every warp advances its lanes (lane w on warp w % nw): one walk over
//   the slots a segment gathers the ongoing and new rows, FIFO pops add to
//   it, a prefill ranks its new and resumed rows among themselves, and
//   reductions over a lane's slots are warp shuffles;
// - po2 draws from a counter-based generator (splitmix64 keyed on the
//   run's seed, `po2_draw` in ops.py) whose counter is part of the state, so
//   a chunk run again replays the same draws;
// - optional counters (`stats`, ops.py's STATS): thread 0 adds the SM
//   cycles of each phase, taken between the barriers that end it, and the
//   counts of beats, tries, placements, (e) tests (one for each lane that
//   passes (a)-(d)), the tested lanes' members and pruned tries. The main
//   path passes none.
//
// Numerics are those of the numpy core, which is bit for bit equal to the
// reference engine: every add and multiply through __dadd_rn/__dmul_rn
// (fp64.cuh; nvcc never contracts those into a fused multiply-add),
// sequential left-associated sums of floats in the numpy core's order (the
// weighted context over the ongoing rows by join sequence, then the new
// batch by placement sequence), `k2*C + c2*b + c3` as
// ((k2*C) + (c2*b)) + c3 with c2*b computed once per segment, decode
// segments that add their iterations one after another, the budget as
// max(((a - c3) - c2*b) / k2, 0), the capacity norm through CPython's
// math.hypot algorithm (`py_hypot`), and the KV peak as h*int + j*int.
// Integer sums (batch, context, tokens) are exact in any order.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "fp64.cuh"
#include "launch.cuh"

namespace {

using namespace repro::fastsim;

constexpr int kMaxWarps = 16;
constexpr int kMaxSmem = 232448;   // what a CTA may use on Hopper
constexpr int kStaticSmem = 1024;  // room for the kernel's static shared
constexpr int kStage = 128;        // queued requests staged at a time
constexpr int kFront = 4;          // requests that found no lane, kept
constexpr long long kBig = 1LL << 50;
constexpr long long kOvfSlots = 1, kOvfQueue = 2;

// The packed state's fields, in the order of ops.py's F_* / I_* tuples.
enum { F_T, F_THETA, NF_SCALARS };
enum { L_TW, L_K1, L_C1, L_K2, L_C2, L_C3, L_H, L_J, L_M, L_MAXBN, L_CMAXN,
       NF_LANES };
enum { R_TDS, R_TF1, R_TPE, R_TFN, R_ARR, NF_ROWS };
enum { I_K, I_IDX, I_QLEN, I_SEQC, I_SEED, I_DRAWS, I_J, I_BUSY_PK,
       I_BUSY_FIN, I_OVF, NI_SCALARS };
enum { L_JC, L_PC, L_MAXB, L_MODE, L_RANK, L_P2L, L_EMPTY, NI_LANES };
enum { R_SST, R_RID, R_LI, R_LR, R_LO, R_NSQ, R_JSQ, R_PSQ, NI_ROWS };
// per-lane values after the state's lane arrays: the placement pass's
// aggregates (the capacity norm and the untagged theta * decode budget
// cached), the rows' counts by state (new 1, ongoing 2, preempted 3; kept
// all along), the members with rem 0 and the sum of the members' rems
enum { A_WCTX, A_DBUD, A_DBUD_T, A_AMIN, A_TMIN, A_NORM, A_CAP, NF_AGG };
enum { A_N1, A_N2, A_N3, A_NEWSUM, A_NEWCTX, A_CTX0, A_Z, A_RSUM, A_FLAG,
       NI_AGG };
// the optional per-candidate counters, in the order of ops.py's STATS
enum { S_CYCLES, S_ADMIT, S_AGG, S_PLACE, S_ADVANCE, S_BILL, S_OCC, S_BEATS,
       S_TRIED, S_PLACED, S_ETESTS, S_MEMBERS, S_MEMBERS_MAX, S_TRY,
       S_COMMIT, S_ANY, S_DOMINATED, NSTAT };

struct Layout {
  size_t nf, ni, f_lane, f_row, i_lane, i_row, q;
  __host__ __device__ Layout(int W, int B, int Q) {
    const size_t wb = static_cast<size_t>(W) * B;
    f_lane = NF_SCALARS;
    f_row = f_lane + static_cast<size_t>(NF_LANES) * W;
    nf = f_row + NF_ROWS * wb;
    i_lane = NI_SCALARS;
    i_row = i_lane + static_cast<size_t>(NI_LANES) * W;
    q = i_row + NI_ROWS * wb;
    ni = q + Q;
  }
};

__host__ __device__ size_t lane_bytes(int W) {
  return 8 * static_cast<size_t>(NF_LANES + NF_AGG + NI_LANES + NI_AGG) * W;
}
// A lane's member list takes an odd number of entries, so that threads
// reading one lane each reach distinct shared-memory banks.
__host__ __device__ int list_stride(int B) { return B | 1; }
// The member memory of a candidate: the lanes' lists (rem and suffix sums
// as int64: 16 B an entry), each warp's build scratch (keys and rems as
// int64, slots and the join order as int32: 24 B a slot), the staged queue
// (kStage requests of six 8-byte values) and the lanes' free-slot masks (a
// bit a slot)
__host__ __device__ size_t member_bytes(int W, int B, int nw) {
  const size_t ls = list_stride(B), words = (B + 63) / 64;
  return 16 * static_cast<size_t>(W) * ls + 24 * static_cast<size_t>(nw) * B +
         48 * static_cast<size_t>(kStage) + 8 * W * words;
}

struct Params {
  const double* arrival;
  const long long* l_in;
  const long long* l_real;
  const long long* rank_r;
  const double* ttft_r;
  const double* atgt_r;
  const long long* s_lo;  // (C, n) re-entrant sinks
  const double* s_f;      // (C, 3, n): t_decode_spent, first token, preempted
  const double* fin;      // (C, nf) packed state in
  const long long* iin;   // (C, ni)
  double* fout;           // (C, nf) packed state out
  long long* iout;        // (C, ni)
  unsigned char* scratch;  // (C, scratch_bytes) when the lists do not fit,
  size_t scratch_bytes;    // else null
  long long* stats;        // (C, NSTAT) or null
  int n, W, B, Q, C;
  double hb, gamma, ttft, atgt;
  int policy;  // 0 aladdin, 1 jsq, 2 po2
  int edf, tagged;
};

// One candidate's state as the kernel sees it: lane arrays and aggregates
// in shared memory (W entries each), rows and the queue in global memory,
// the member lists and the warps' scratch where they fit.
struct State {
  double* lf;       // (NF_LANES + NF_AGG, W)
  long long* li;    // (NI_LANES + NI_AGG, W)
  double* rf;       // (NF_ROWS, W * B)
  long long* ri;    // (NI_ROWS, W * B)
  long long* q;
  long long* mrem;  // (W, ls) a lane's members' rem, ascending
  long long* msuf;  // (W, ls) suffix sums of their contexts, same order
  long long* wkey;  // (nw, B) a warp's scratch: keys
  long long* wrem;  // (nw, B) rems
  int* wslot;       // (nw, B) slots
  int* wjoin;       // (nw, B) the members' slots in join order
  long long* qst;   // (6, kStage) staged requests: id, l_in, l_real, l_out
                    // sink, then (as double) atgt and ttft budgets
  unsigned long long* free;  // (W, fw) a lane's free slots, a bit each
  int W, B, ls, fw;
  size_t wb;
  __device__ double& f(int k, int w) const { return lf[k * W + w]; }
  __device__ long long& i(int k, int w) const { return li[k * W + w]; }
  __device__ double& rowf(int k, size_t s) const { return rf[k * wb + s]; }
  __device__ long long& rowi(int k, size_t s) const { return ri[k * wb + s]; }
  __device__ long long& sst(size_t s) const { return rowi(R_SST, s); }
  __device__ double& aggf(int k, int w) const { return f(NF_LANES + k, w); }
  __device__ long long& agg(int k, int w) const { return i(NI_LANES + k, w); }
  __device__ long long members(int w) const {
    return agg(A_N1, w) + agg(A_N2, w);
  }
  __device__ size_t list(int w) const { return static_cast<size_t>(w) * ls; }
};

__device__ __forceinline__ unsigned long long mix64(unsigned long long z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}
// po2_draw in ops.py
__device__ __forceinline__ unsigned long long po2_draw(long long seed,
                                                       long long counter) {
  return mix64(mix64(static_cast<unsigned long long>(seed)) +
               static_cast<unsigned long long>(counter + 1) *
                   0x9E3779B97F4A7C15ull);
}

// (key, index) argmin across the warp; index -1 means none; ties to the
// lower index
__device__ __forceinline__ void warp_argmin(long long& key, int& idx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long k2 = __shfl_xor_sync(kFull, key, o);
    const int i2 = __shfl_xor_sync(kFull, idx, o);
    if (i2 >= 0 && (idx < 0 || k2 < key || (k2 == key && i2 < idx))) {
      key = k2;
      idx = i2;
    }
  }
}

// Lane w's untagged constraint (c) bound, theta * max(((atgt - c3) -
// c2*b) / k2, 0) at the batch b it would have with one more request, and
// its capacity norm: both change only when the lane takes a request.
__device__ void lane_cache(const Params& p, const State& S, int w,
                           double theta) {
  const long long cnt = S.members(w);
  const double k2 = S.f(L_K2, w);
  const double budget =
      k2 > 0.0 ? max0(dvd(sub(sub(p.atgt, S.f(L_C3, w)),
                              mul(S.f(L_C2, w), static_cast<double>(cnt + 1))),
                          k2))
               : CUDART_INF;
  S.aggf(A_CAP, w) = mul(theta, budget);
  S.aggf(A_NORM, w) = py_hypot(dvd(static_cast<double>(cnt), S.f(L_MAXBN, w)),
                               dvd(S.aggf(A_WCTX, w), S.f(L_CMAXN, w)));
}

// Lane w's aggregates for a placement pass (warp-wide; serving lanes only):
// new tokens and context of the new batch, context of the ongoing rows,
// constraint (d)'s budgets over the ongoing rows and, for tagged traces,
// the strictest member budgets; the weighted context, summed over the
// members' slots put in join order in the warp's scratch; and (aladdin)
// its member list, the rems ascending beside the suffix sums of the
// contexts.
__device__ void lane_aggregates(const Params& p, const State& S, int w,
                                int warp, int lane, double theta, bool al,
                                bool tag_a) {
  const int B = p.B;
  const size_t o = static_cast<size_t>(w) * B;
  long long* const key = S.wkey + static_cast<size_t>(warp) * B;
  long long* const wr = S.wrem + static_cast<size_t>(warp) * B;
  int* const ws = S.wslot + static_cast<size_t>(warp) * B;
  int* const jl = S.wjoin + static_cast<size_t>(warp) * B;
  long long* const rem = S.mrem + S.list(w);
  long long* const suf = S.msuf + S.list(w);
  int m = 0;
  long long newsum = 0, newctx = 0, ctx0 = 0, z = 0, rsum = 0;
  double slack = CUDART_INF, slack_t = CUDART_INF;
  double amin = CUDART_INF, tmin = CUDART_INF;
  // one walk over the slots: the members, compacted in slot order into the
  // warp's scratch with their join keys and rems
  for (int s0 = 0; s0 < B; s0 += 32) {
    const int s = s0 + lane;
    const long long st = s < B ? S.sst(o + s) : 0;
    const bool mem = st == 1 || st == 2;
    const unsigned mask = __ballot_sync(kFull, mem);
    if (mem) {
      const size_t x = o + s;
      const int pos = m + __popc(mask & ((1u << lane) - 1u));
      const long long li = S.rowi(R_LI, x), lo = S.rowi(R_LO, x);
      const long long lr = S.rowi(R_LR, x);
      const long long r = S.rowi(R_RID, x);
      const long long rm = lr - lo > 0 ? lr - lo : 0;
      ws[pos] = s;
      key[pos] = st == 2 ? S.rowi(R_JSQ, x) : kBig + S.rowi(R_NSQ, x);
      wr[pos] = rm;
      z += rm == 0;
      rsum += rm;
      if (tag_a) amin = pmin(amin, p.atgt_r[r]);
      if (st == 1) {
        newsum += li;
        newctx += li + lo;
        if (tag_a) tmin = pmin(tmin, p.ttft_r[r]);
      } else {
        ctx0 += li + lo;
        if (al) {
          const double mo = static_cast<double>(lo > 1 ? lo - 1 : 0);
          const double tds = S.rowf(R_TDS, x);
          slack = pmin(slack, sub(mul(p.atgt, mo), tds));
          if (tag_a) {
            double am = p.atgt_r[r];
            am = isinf(am) ? p.atgt : am;
            slack_t = pmin(slack_t, sub(mul(am, mo), tds));
          }
        }
      }
    }
    m += __popc(mask);
  }
  newsum = warp_sum(newsum);
  newctx = warp_sum(newctx);
  ctx0 = warp_sum(ctx0);
  z = warp_sum(z);
  rsum = warp_sum(rsum);
  slack = warp_min(slack);
  slack_t = warp_min(slack_t);
  amin = warp_min(amin);
  tmin = warp_min(tmin);
  __syncwarp();
  // ranks among the members: join order (unique keys: join sequences stay
  // below kBig) and rem order (ties in slot order)
  for (int q = lane; q < m; q += 32) {
    const long long kq = key[q], rq = wr[q];
    int rj = 0, rr = 0;
    for (int t = 0; t < m; ++t) {
      rj += key[t] < kq;
      const long long rt = wr[t];
      rr += rt < rq || (rt == rq && t < q);
    }
    const int s = ws[q];
    jl[rj] = s;
    if (al) {
      rem[rr] = rq;
      suf[rr] = S.rowi(R_LI, o + s) + S.rowi(R_LO, o + s);
    }
  }
  __syncwarp();
  // the weighted context in the numpy core's order: one chain of adds over
  // the join-ordered list (a float sum, so the order shows in the last ulp)
  double wctx = 0.0;
  for (int c0 = 0; c0 < m; c0 += 32) {
    const int q = c0 + lane;
    double v = 0.0;
    if (q < m) {
      const size_t x = o + jl[q];
      v = add(static_cast<double>(S.rowi(R_LI, x)),
              mul(p.gamma, static_cast<double>(S.rowi(R_LR, x))));
    }
    const int nq = m - c0 < 32 ? m - c0 : 32;
    for (int t = 0; t < nq; ++t) wctx = add(wctx, __shfl_sync(kFull, v, t));
  }
  // suffix sums of the contexts in rem order, top chunk first
  if (al) {
    long long carry = 0;
    for (int c0 = ((m - 1) >> 5) << 5; m > 0 && c0 >= 0; c0 -= 32) {
      const int q = c0 + lane;
      long long v = q < m ? suf[q] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long u = __shfl_down_sync(kFull, v, d);
        if (lane + d < 32) v += u;
      }
      v += carry;
      if (q < m) suf[q] = v;
      carry = __shfl_sync(kFull, v, 0);
    }
  }
  if (lane == 0) {
    S.aggf(A_WCTX, w) = wctx;
    S.agg(A_NEWSUM, w) = newsum;
    S.agg(A_NEWCTX, w) = newctx;
    S.agg(A_CTX0, w) = ctx0;
    S.agg(A_Z, w) = z;
    S.agg(A_RSUM, w) = rsum;
    S.aggf(A_DBUD, w) = al ? mul(theta, max0(slack)) : 0.0;
    S.aggf(A_DBUD_T, w) = al ? mul(theta, max0(slack_t)) : 0.0;
    S.aggf(A_AMIN, w) = amin;
    S.aggf(A_TMIN, w) = tmin;
    if (al) lane_cache(p, S, w, theta);
  }
  __syncwarp();
}

// Constraint (e) (one thread): whether the peak KV demand of lane x's
// members plus the candidate (remaining rem_c, context ctx_c) stays within
// theta * M over every future step count at which one of them ends, i.e.
// whether max(h*sum(ctx) + j*count, max over k of h*(sum of ctx with rem >=
// k + count*k) + j*count), as kv_peak_arrays computes it, is at most theta
// * M: every term is, so the first term above it ends the test.
__device__ bool kv_fits(const State& S, int x, long long rem_c,
                        long long ctx_c, double theta) {
  const long long* const rem = S.mrem + S.list(x);
  const long long* const suf = S.msuf + S.list(x);
  const long long m = S.members(x), z = S.agg(A_Z, x);
  const double h = S.f(L_H, x), jv = S.f(L_J, x);
  const double cap = mul(theta, S.f(L_M, x));
  // the members with rem >= k start at index idx of the sorted list
  auto fits = [&](long long k, long long idx) {
    const bool cand = rem_c >= k;
    const long long cnt = (m - idx) + cand;
    if (cnt == 0) return true;
    const long long sum = (idx < m ? suf[idx] : 0) + (cand ? ctx_c : 0);
    return add(mul(h, static_cast<double>(sum + cnt * k)),
               mul(jv, static_cast<double>(cnt))) <= cap;
  };
  const long long s0 = (m > 0 ? suf[0] : 0) + ctx_c;
  if (!(add(mul(h, static_cast<double>(s0)),
            mul(jv, static_cast<double>(m + 1))) <= cap))
    return false;
  // every term is at most h*(s0 + X) + j*(m + 1), X bounding count*k by
  // the sum of the rems and by (m + 1) times the largest rem (a threshold
  // is the rem of one of those it counts); rounding keeps the order, so
  // when that bound fits, every term does
  if (h >= 0.0 && jv >= 0.0) {
    const long long top = m > 0 && rem[m - 1] > rem_c ? rem[m - 1] : rem_c;
    const long long all = S.agg(A_RSUM, x) + rem_c, cap_k = (m + 1) * top;
    if (add(mul(h, static_cast<double>(s0 + (all < cap_k ? all : cap_k))),
            mul(jv, static_cast<double>(m + 1))) <= cap)
      return true;
  }
  const long long kc = rem_c > 1 ? rem_c : 1;
  // each member's threshold at the first member of its rem (members with
  // rem 0 end at k = 1); the candidate's index counted on the way
  long long below = 0, prev = 0;
  for (long long q = 0; q < m; ++q) {
    const long long r = rem[q];
    below += r < kc;
    if (r > prev && !fits(r, q)) return false;
    prev = r;
  }
  return (z == 0 || fits(1, z)) && fits(kc, below);
}

// Lane w takes a member (warp-wide): its rem in sorted place, the suffix
// sums at and below it grown by its context. Call before the lane's count
// grows.
__device__ void list_insert(const State& S, int w, int lane,
                            long long rem_c, long long ctx_c) {
  long long* const rem = S.mrem + S.list(w);
  long long* const suf = S.msuf + S.list(w);
  const int m = static_cast<int>(S.members(w));
  long long ins = 0;
  for (int q = lane; q < m; q += 32) ins += rem[q] < rem_c;
  ins = warp_sum(ins);
  // shift the top chunk first, so a chunk reads its lower neighbour before
  // that neighbour moves
  for (int c0 = (m >> 5) << 5; c0 >= 0; c0 -= 32) {
    const int q = c0 + lane;
    long long nr = 0, ns = 0;
    if (q <= m) {
      if (q < ins) {
        nr = rem[q];
        ns = suf[q] + ctx_c;
      } else if (q == ins) {
        nr = rem_c;
        ns = ctx_c + (ins < m ? suf[ins] : 0);
      } else {
        nr = rem[q - 1];
        ns = suf[q - 1];
      }
    }
    __syncwarp();
    if (q <= m) {
      rem[q] = nr;
      suf[q] = ns;
    }
    __syncwarp();
  }
  if (lane == 0) {
    if (rem_c == 0) S.agg(A_Z, w) += 1;
    S.agg(A_RSUM, w) += rem_c;
  }
}

// The placement pass over the backlog (every thread; ends on a barrier).
// The queue is staged in shared memory kStage requests at a time. For each
// request one thread a lane tests constraints (a)-(d) and, for aladdin,
// (e) on a lane that passes them, and flags the lane (1 feasible, 2 also
// within (e)); one barrier tells whether any lane can take it; warp 0
// chooses and commits. Unplaced requests stay queued in their order at the
// head of the queue; the int scalars (qlen, seqc, draws, ovf) are warp 0's,
// written to `sc` at the end.
__device__ void place_pass(const Params& p, const State& S, long long* sc,
                           double theta, int nserv, bool mono,
                           const long long* s_lo, const double* s_tds,
                           const double* s_tf1, const double* s_tpe,
                           long long* stat) {
  const int W = p.W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool al = p.policy == 0, jsq = p.policy == 1;
  const bool tag_a = p.tagged && al;
  long long* const q = S.q;
  const long long qlen = sc[I_QLEN];
  long long seqc = sc[I_SEQC], draws = sc[I_DRAWS], ovf = sc[I_OVF];
  long long keep = 0;
  // Within a pass a lane only fills up, and with `mono` constraints (a)-(d)
  // only get stricter with it and with a larger untagged request (more
  // weighted context v, more prompt l_in). So an untagged request that is
  // no smaller in both than one that found no lane finds none either, and
  // stays queued without a round. Each thread keeps the same kFront of
  // those requests.
  const bool prune = al && mono;
  double front_v[kFront];
  long long front_l[kFront];
  int nfront = 0, slot_f = 0;
  long long* const st_r = S.qst;
  long long* const st_li = st_r + kStage;
  long long* const st_lr = st_li + kStage;
  long long* const st_lo = st_lr + kStage;
  double* const st_ar = reinterpret_cast<double*>(st_lo + kStage);
  double* const st_tr = st_ar + kStage;
  // the placement pass's own split (thread 0): each try's round over the
  // lanes, and the choice and commit
  long long mark = stat && tid == 0 ? clock64() : 0;
  auto lap = [&](int k) {
    if (stat && tid == 0) {
      const long long now = clock64();
      stat[k] += now - mark;
      mark = now;
    }
  };
  for (long long base = 0; base < qlen; base += kStage) {
    const int nb = qlen - base < kStage ? static_cast<int>(qlen - base)
                                        : kStage;
    // the batch's requests and their trace values, one thread each (a
    // request that stays queued is written back below the batch)
    __syncthreads();
    for (int k = tid; k < nb; k += blockDim.x) {
      const long long r = q[base + k];
      st_r[k] = r;
      st_li[k] = p.l_in[r];
      st_lr[k] = p.l_real[r];
      st_lo[k] = s_lo[r];
      st_ar[k] = p.atgt_r[r];
      st_tr[k] = p.ttft_r[r];
    }
    __syncthreads();
    lap(S_TRY);
    for (int k = 0; k < nb; ++k) {
      const long long r = st_r[k];
      const long long liv = st_li[k], lrv = st_lr[k], lov = st_lo[k];
      const double v = add(static_cast<double>(liv),
                           mul(p.gamma, static_cast<double>(lrv)));
      const double ar = st_ar[k], tr = st_tr[k];
      const bool ct = tag_a && isfinite(ar);
      if (prune && !ct) {
        bool dom = false;
#pragma unroll
        for (int u = 0; u < kFront; ++u)
          dom = dom || (u < nfront && v >= front_v[u] && liv >= front_l[u]);
        if (dom) {
          if (stat && tid == 0) {
            stat[S_TRIED] += 1;
            stat[S_DOMINATED] += 1;
          }
          if (warp == 0) {
            if (lane == 0) q[keep] = r;
            ++keep;
          }
          continue;
        }
      }
      const long long rem_c = lrv - lov > 0 ? lrv - lov : 0;
      const long long ctx_c = liv + lov;
      bool feas = false, any = false;
      for (int x = tid; x < W; x += blockDim.x) {
        long long fl = 0;
        if (S.i(L_MODE, x) == 2) {
          const long long cnt = S.members(x);
          if (al) {
            double cap = S.aggf(A_CAP, x), t_eff = p.ttft;
            double d_eff = S.aggf(A_DBUD, x);
            if (ct) {  // an untagged candidate takes the scalar branch
              const double a0 = pmin(S.aggf(A_AMIN, x), ar);
              const double a_eff = isinf(a0) ? p.atgt : a0;
              const double t0 = pmin(S.aggf(A_TMIN, x), tr);
              t_eff = isinf(t0) ? p.ttft : t0;
              d_eff = S.aggf(A_DBUD_T, x);
              const double k2 = S.f(L_K2, x);
              cap = mul(theta,
                        k2 > 0.0
                            ? max0(dvd(sub(sub(a_eff, S.f(L_C3, x)),
                                           mul(S.f(L_C2, x),
                                               static_cast<double>(cnt + 1))),
                                       k2))
                            : CUDART_INF);
            }
            const double pre_t = add(
                mul(S.f(L_K1, x),
                    static_cast<double>(S.agg(A_NEWSUM, x) + liv)),
                S.f(L_C1, x));
            if (cnt + 1 <= S.i(L_MAXB, x) &&
                add(S.aggf(A_WCTX, x), v) <= cap && pre_t <= t_eff &&
                pre_t <= d_eff) {
              fl = kv_fits(S, x, rem_c, ctx_c, theta) ? 2 : 1;
              if (stat) {  // a feasible lane, tested for (e)
                atomicAdd(reinterpret_cast<unsigned long long*>(
                              &stat[S_ETESTS]), 1ull);
                atomicAdd(reinterpret_cast<unsigned long long*>(
                              &stat[S_MEMBERS]),
                          static_cast<unsigned long long>(cnt));
                atomicMax(&stat[S_MEMBERS_MAX], cnt);
              }
            }
          } else {
            const double h = S.f(L_H, x), jv = S.f(L_J, x);
            const double kv_now = add(
                add(mul(h, static_cast<double>(S.agg(A_CTX0, x) +
                                               S.agg(A_NEWCTX, x))),
                    mul(jv, static_cast<double>(cnt))),
                add(mul(h, static_cast<double>(liv)), jv));
            fl = kv_now <= S.f(L_M, x) && cnt + 1 <= S.i(L_MAXB, x);
          }
        }
        S.agg(A_FLAG, x) = fl;
        feas = feas || fl != 0;
        any = any || fl == (al ? 2 : 1);
      }
      if (!al) {
        any = __syncthreads_or(any);
      } else if (__syncthreads_count(feas) > 0) {
        any = __syncthreads_or(any);
      } else {  // no lane passes (a)-(d)
        any = false;
        if (prune && !ct) {
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
      }
      if (stat && tid == 0) {
        stat[S_TRIED] += 1;
        stat[S_ANY] += any;
      }
      lap(S_TRY);
      if (!any) {  // no lane: it stays queued (po2 still draws its pair)
        if (warp == 0) {
          if (p.policy == 2 && nserv >= 2) draws += 2;
          if (lane == 0) q[keep] = r;
          ++keep;
        }
        continue;
      }
      if (warp == 0) {
        int w = -1;
        if (al) {
          // the lazy best-fit walk's lane: the first by capacity norm
          // (largest first), ties in serving order, among those within (e)
          int best = -1;
          double bn = 0.0;
          long long br = 0;
          for (int x = lane; x < W; x += 32) {
            if (S.agg(A_FLAG, x) != 2) continue;
            const double nx = S.aggf(A_NORM, x);
            const long long rx = S.i(L_RANK, x);
            if (best < 0 || nx > bn || (nx == bn && rx < br)) {
              best = x;
              bn = nx;
              br = rx;
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const int b2 = __shfl_xor_sync(kFull, best, o);
            const double n2 = __shfl_xor_sync(kFull, bn, o);
            const long long r2 = __shfl_xor_sync(kFull, br, o);
            if (b2 >= 0 && (best < 0 || n2 > bn || (n2 == bn && r2 < br))) {
              best = b2;
              bn = n2;
              br = r2;
            }
          }
          w = best;
        } else {
          int c1 = -1, c2 = -1;
          if (!jsq) {
            if (nserv >= 2) {
              const unsigned long long u1 = po2_draw(sc[I_SEED], draws);
              const unsigned long long u2 = po2_draw(sc[I_SEED], draws + 1);
              draws += 2;
              const unsigned long long r1 = u1 % nserv,
                                       r2 = u2 % (nserv - 1);
              c1 = static_cast<int>(S.i(L_P2L, static_cast<int>(r1)));
              c2 = static_cast<int>(
                  S.i(L_P2L, static_cast<int>(r2 + (r2 >= r1 ? 1 : 0))));
              if (S.aggf(A_WCTX, c2) < S.aggf(A_WCTX, c1)) {
                const int tmp = c1;
                c1 = c2;
                c2 = tmp;
              }
            } else if (nserv == 1) {
              c1 = static_cast<int>(S.i(L_P2L, 0));
            }
            if (c1 >= 0 && S.agg(A_FLAG, c1)) {
              w = c1;
            } else if (c2 >= 0 && S.agg(A_FLAG, c2)) {
              w = c2;
            }
          }
          if (w < 0) {
            // jsq: the smallest batch; po2's fallback: the least weighted
            // context; ties in serving order
            int best = -1;
            double bk = 0.0;
            long long br = 0;
            for (int x = lane; x < W; x += 32) {
              if (!S.agg(A_FLAG, x) || x == c1 || x == c2) continue;
              const double kx = jsq ? static_cast<double>(S.members(x))
                                    : S.aggf(A_WCTX, x);
              const long long rx = S.i(L_RANK, x);
              if (best < 0 || kx < bk || (kx == bk && rx < br)) {
                best = x;
                bk = kx;
                br = rx;
              }
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              const int b2 = __shfl_xor_sync(kFull, best, o);
              const double k2 = __shfl_xor_sync(kFull, bk, o);
              const long long r2 = __shfl_xor_sync(kFull, br, o);
              if (b2 >= 0 &&
                  (best < 0 || k2 < bk || (k2 == bk && r2 < br))) {
                best = b2;
                bk = k2;
                br = r2;
              }
            }
            w = best;
          }
        }
        // lane w's first free slot, from its mask
        int slot = -1;
        if (w >= 0) {
          const unsigned long long* fm =
              S.free + static_cast<size_t>(w) * S.fw;
          for (int u = 0; u < S.fw; ++u) {
            if (fm[u]) {
              slot = 64 * u + __ffsll(static_cast<long long>(fm[u])) - 1;
              break;
            }
          }
          if (slot < 0) ovf |= kOvfSlots;
        }
        if (slot < 0) {  // stays queued, FIFO order kept
          if (lane == 0) q[keep] = r;
          ++keep;
        } else {
          if (lane == 0) {
            if (stat) stat[S_PLACED] += 1;
            S.free[static_cast<size_t>(w) * S.fw + (slot >> 6)] &=
                ~(1ull << (slot & 63));
            const size_t x = static_cast<size_t>(w) * S.B + slot;
            S.sst(x) = 1;
            S.rowi(R_RID, x) = r;
            S.rowi(R_LI, x) = liv;
            S.rowi(R_LR, x) = lrv;
            S.rowi(R_LO, x) = lov;
            S.rowf(R_TDS, x) = s_tds[r];
            S.rowf(R_TF1, x) = s_tf1[r];
            S.rowf(R_TPE, x) = s_tpe[r];
            S.rowf(R_TFN, x) = CUDART_NAN;
            S.rowf(R_ARR, x) = p.arrival[r];
            S.rowi(R_NSQ, x) = seqc;
            S.rowi(R_JSQ, x) = 0;
            S.rowi(R_PSQ, x) = 0;
            S.agg(A_NEWSUM, w) += liv;
            S.agg(A_NEWCTX, w) += liv + lov;
            S.aggf(A_WCTX, w) = add(S.aggf(A_WCTX, w), v);
            if (tag_a) {
              S.aggf(A_AMIN, w) = pmin(S.aggf(A_AMIN, w), ar);
              S.aggf(A_TMIN, w) = pmin(S.aggf(A_TMIN, w), tr);
            }
          }
          __syncwarp();
          if (al) list_insert(S, w, lane, rem_c, ctx_c);
          __syncwarp();
          if (lane == 0) {
            S.agg(A_N1, w) += 1;
            if (al) lane_cache(p, S, w, theta);
          }
          ++seqc;
        }
      }
      __syncthreads();
      lap(S_COMMIT);
    }
  }
  if (tid == 0) {
    sc[I_QLEN] = keep;
    sc[I_SEQC] = seqc;
    sc[I_DRAWS] = draws;
    sc[I_OVF] = ovf;
  }
}

// Lane w's advance_to(t_end) with the KV semantics of the numpy core's
// _Engine._advance (warp-wide): FIFO head-blocking resume against the
// occupancy before the pops, joint prefill of the new batch and the resumed
// rows while everyone else stalls, KV-overflow eviction of the youngest
// arrival (ties to the earliest joiner), and decode segments that end at a
// finish, a KV overflow or the beat end. Finished rows park as state 5. The
// lane's counts by state follow each change.
__device__ void advance_lane(const Params& p, const State& S, int w,
                             int warp, int lane, double t_start,
                             double t_end) {
  const int B = p.B;
  const size_t o = static_cast<size_t>(w) * B;
  long long* const key = S.wkey + static_cast<size_t>(warp) * B;
  const double k1 = S.f(L_K1, w), c1 = S.f(L_C1, w), k2 = S.f(L_K2, w),
               c2 = S.f(L_C2, w), c3 = S.f(L_C3, w), h = S.f(L_H, w),
               jv = S.f(L_J, w), M = S.f(L_M, w);
  long long jc = S.i(L_JC, w), pc = S.i(L_PC, w);
  long long n1 = S.agg(A_N1, w), n2 = S.agg(A_N2, w), n3 = S.agg(A_N3, w);
  double t = S.f(L_TW, w);
  // a lane that sat booting or idle starts its pending work at the beat
  // start
  if (n1 + n3 > 0 && t < t_start && t < t_end) t = t_start;
  const double thr = mul(0.9, M);
  while (t < t_end) {
    // one walk over the slots: the ongoing rows (count, context, the
    // fewest tokens any of them has left) and the new ones (count,
    // context); each FIFO pop below adds its row to the resumed ones
    long long n_on = 0, C = 0, nnew = 0, tot = 0, n_fin = kBig;
    for (int s = lane; s < B; s += 32) {
      const size_t x = o + s;
      const long long st = S.sst(x);
      if (st == 2) {
        const long long lo = S.rowi(R_LO, x);
        ++n_on;
        C += S.rowi(R_LI, x) + lo;
        const long long left = S.rowi(R_LR, x) - lo;
        const long long l1 = left > 1 ? left : 1;
        n_fin = l1 < n_fin ? l1 : n_fin;
      } else if (st == 1) {
        ++nnew;
        tot += S.rowi(R_LI, x) + S.rowi(R_LO, x);
      }
    }
    n_on = warp_sum(n_on);
    C = warp_sum(C);
    nnew = warp_sum(nnew);
    tot = warp_sum(tot);
    n_fin = warp_min(n_fin);
    const double base = add(mul(h, static_cast<double>(C)),
                            mul(jv, static_cast<double>(n_on)));
    // FIFO resume: pop the head while it fits under 0.9 M
    long long nres = 0;
    while (nres < n3) {
      long long hk = 0;
      int head = -1;
      for (int s = lane; s < B; s += 32) {
        const size_t x = o + s;
        if (S.sst(x) == 3 && (head < 0 || S.rowi(R_PSQ, x) < hk)) {
          hk = S.rowi(R_PSQ, x);
          head = s;
        }
      }
      warp_argmin(hk, head);
      if (head < 0) break;
      const long long ctx_h = S.rowi(R_LI, o + head) + S.rowi(R_LO, o + head);
      const double occ =
          add(add(base, mul(h, static_cast<double>(ctx_h))), jv);
      if (!(occ <= thr)) break;
      __syncwarp();
      if (lane == 0) S.sst(o + head) = 4;
      __syncwarp();
      ++nres;
      tot += ctx_h;
    }
    if (nnew + nres > 0) {
      const double dur = add(mul(k1, static_cast<double>(tot)), c1);
      const double t_pre = add(t, dur);
      // join order: new rows by placement sequence, then the resumed rows
      // by preemption sequence, each ranked among its own kind, whose keys
      // the warp's scratch holds (the new ones first)
      long long b1 = 0, b4 = nnew;
      for (int s0 = 0; s0 < B; s0 += 32) {
        const int s = s0 + lane;
        const long long st = s < B ? S.sst(o + s) : 0;
        const unsigned lt = (1u << lane) - 1u;
        const unsigned m1 = __ballot_sync(kFull, st == 1);
        const unsigned m4 = __ballot_sync(kFull, st == 4);
        if (st == 1) key[b1 + __popc(m1 & lt)] = S.rowi(R_NSQ, o + s);
        if (st == 4) key[b4 + __popc(m4 & lt)] = S.rowi(R_PSQ, o + s);
        b1 += __popc(m1);
        b4 += __popc(m4);
      }
      __syncwarp();
      for (int s = lane; s < B; s += 32) {
        const size_t x = o + s;
        const long long st = S.sst(x);
        if (st == 1 || st == 4) {
          const long long mine = S.rowi(st == 1 ? R_NSQ : R_PSQ, x);
          const long long lo = st == 1 ? 0 : nnew;
          const long long hi = st == 1 ? nnew : nnew + nres;
          long long rk = 0;
          for (long long u = lo; u < hi; ++u) rk += key[u] < mine;
          S.rowi(R_JSQ, x) = jc + lo + rk;
        }
        if (st == 2 || st == 3 || st == 4) {
          S.rowf(R_TDS, x) = add(S.rowf(R_TDS, x), dur);
        } else if (st == 1) {
          if (isnan(S.rowf(R_TF1, x))) {
            S.rowf(R_TF1, x) = t_pre;
            S.rowi(R_LO, x) = 1;
          } else if (!isnan(S.rowf(R_TPE, x))) {
            // a KV-loss re-entrant: the stall since the reclaim
            S.rowf(R_TDS, x) = add(S.rowf(R_TDS, x),
                                   max0(sub(t_pre, S.rowf(R_TPE, x))));
          }
          S.rowf(R_TPE, x) = CUDART_NAN;
        }
        if (st == 1 || st == 4) S.sst(x) = 2;
      }
      __syncwarp();
      jc += nnew + nres;
      n1 -= nnew;
      n3 -= nres;
      n2 += nnew + nres;
      t = t_pre;
      continue;
    }
    if (n_on == 0) {
      t = t_end;
      break;
    }
    long long b = n_on;
    while (add(mul(h, static_cast<double>(C)),
               mul(jv, static_cast<double>(b))) > M &&
           b > 1) {
      // evict the youngest arrival, ties to the earliest joiner
      int vic = -1;
      double va = 0.0;
      long long vj = 0;
      for (int s = lane; s < B; s += 32) {
        const size_t x = o + s;
        if (S.sst(x) != 2) continue;
        const double a = S.rowf(R_ARR, x);
        const long long jq = S.rowi(R_JSQ, x);
        if (vic < 0 || a > va || (a == va && jq < vj)) {
          vic = s;
          va = a;
          vj = jq;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int v2 = __shfl_xor_sync(kFull, vic, off);
        const double a2 = __shfl_xor_sync(kFull, va, off);
        const long long j2 = __shfl_xor_sync(kFull, vj, off);
        if (v2 >= 0 && (vic < 0 || a2 > va || (a2 == va && j2 < vj))) {
          vic = v2;
          va = a2;
          vj = j2;
        }
      }
      C -= S.rowi(R_LI, o + vic) + S.rowi(R_LO, o + vic);
      --b;
      __syncwarp();
      if (lane == 0) {
        S.sst(o + vic) = 3;
        S.rowi(R_PSQ, o + vic) = pc;
      }
      ++pc;
      --n2;
      ++n3;
      __syncwarp();
    }
    if (b < n_on) {  // the evicted rows no longer bound the segment
      n_fin = kBig;
      for (int s = lane; s < B; s += 32) {
        const size_t x = o + s;
        if (S.sst(x) != 2) continue;
        const long long left = S.rowi(R_LR, x) - S.rowi(R_LO, x);
        const long long l1 = left > 1 ? left : 1;
        n_fin = l1 < n_fin ? l1 : n_fin;
      }
      n_fin = warp_min(n_fin);
    }
    // a decode segment: the batch is fixed until a finish, a KV overflow
    // or the beat end
    const double cb = mul(c2, static_cast<double>(b));
    long long k = 0;
    double td = t, seg = 0.0;
    while (k < n_fin && td < t_end) {
      const long long ck = C + k * b;
      if (k > 0 &&
          add(mul(h, static_cast<double>(ck)),
              mul(jv, static_cast<double>(b))) > M &&
          b > 1)
        break;
      const double dur =
          add(add(mul(k2, static_cast<double>(ck)), cb), c3);
      ++k;
      td = add(td, dur);
      seg = add(seg, dur);
    }
    long long done = 0;
    for (int s = lane; s < B; s += 32) {
      const size_t x = o + s;
      const long long st = S.sst(x);
      if (st == 2) {
        S.rowi(R_LO, x) += k;
        S.rowf(R_TDS, x) = add(S.rowf(R_TDS, x), seg);
        if (S.rowi(R_LO, x) >= S.rowi(R_LR, x)) {
          S.rowf(R_TFN, x) = td;
          S.sst(x) = 5;
          ++done;
        }
      } else if (st == 3) {  // preempted clocks stall too
        S.rowf(R_TDS, x) = add(S.rowf(R_TDS, x), seg);
      }
    }
    n2 -= warp_sum(done);
    __syncwarp();
    t = td;
  }
  if (lane == 0) {
    S.f(L_TW, w) = t;
    S.i(L_JC, w) = jc;
    S.i(L_PC, w) = pc;
    S.agg(A_N1, w) = n1;
    S.agg(A_N2, w) = n2;
    S.agg(A_N3, w) = n3;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    chunk_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_t, s_theta;
  __shared__ long long sc[NI_SCALARS];
  __shared__ long long s_stat[NSTAT];
  __shared__ int s_nserv, s_busy, s_mono;

  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int n = p.n, W = p.W, B = p.B;
  const Layout lay(W, B, p.Q);
  const double* fin = p.fin + c * lay.nf;
  const long long* iin = p.iin + c * lay.ni;
  double* fo = p.fout + c * lay.nf;
  long long* io = p.iout + c * lay.ni;
  const long long* s_lo = p.s_lo + static_cast<size_t>(c) * n;
  const double* s_tds = p.s_f + static_cast<size_t>(c) * 3 * n;
  const double* s_tf1 = s_tds + n;
  const double* s_tpe = s_tds + 2 * n;
  const bool al = p.policy == 0, tag_a = p.tagged && al;
  // the counters: thread 0 adds the cycles between the barriers that end
  // each phase, and the counts
  long long* const stat = p.stats ? s_stat : nullptr;
  const long long t_begin = clock64();
  long long mark = t_begin;
  auto lap = [&](int k) {
    if (stat && tid == 0) {
      const long long now = clock64();
      stat[k] += now - mark;
      mark = now;
    }
  };

  State S;
  S.lf = reinterpret_cast<double*>(smem);
  S.li = reinterpret_cast<long long*>(S.lf + (NF_LANES + NF_AGG) * W);
  S.rf = fo + lay.f_row;
  S.ri = io + lay.i_row;
  S.q = io + lay.q;
  S.W = W;
  S.B = B;
  S.ls = list_stride(B);
  S.fw = (B + 63) / 64;
  S.wb = static_cast<size_t>(W) * B;
  {
    const size_t wl = static_cast<size_t>(W) * S.ls;
    const size_t nb = static_cast<size_t>(nw) * B;
    unsigned char* const mm =
        p.scratch ? p.scratch + c * p.scratch_bytes
                  : reinterpret_cast<unsigned char*>(S.li +
                                                     (NI_LANES + NI_AGG) * W);
    S.mrem = reinterpret_cast<long long*>(mm);
    S.msuf = S.mrem + wl;
    S.wkey = S.msuf + wl;
    S.wrem = S.wkey + nb;
    S.qst = S.wrem + nb;
    S.free = reinterpret_cast<unsigned long long*>(S.qst + 6 * kStage);
    S.wslot = reinterpret_cast<int*>(S.free + static_cast<size_t>(W) * S.fw);
    S.wjoin = S.wslot + nb;
  }

  // the state in -> out (the kernel works on the output); lanes to shared
  for (size_t k = tid; k < lay.nf; k += blockDim.x) fo[k] = fin[k];
  for (size_t k = tid; k < lay.ni; k += blockDim.x) io[k] = iin[k];
  for (int k = tid; k < NF_LANES * W; k += blockDim.x)
    S.lf[k] = fin[lay.f_lane + k];
  for (int k = tid; k < NI_LANES * W; k += blockDim.x)
    S.li[k] = iin[lay.i_lane + k];
  if (tid == 0) {
    s_t = fin[F_T];
    s_theta = fin[F_THETA];
    for (int k = 0; k < NI_SCALARS; ++k) sc[k] = iin[k];
    for (int k = 0; k < NSTAT; ++k) s_stat[k] = 0;
    int ns = 0;
    for (int w = 0; w < W; ++w) ns += iin[lay.i_lane + L_MODE * W + w] == 2;
    s_nserv = ns;
    // constraints (a)-(d) only tighten as a lane fills (the placement
    // pass's pruning): no negative weight, decode slope or prefill slope
    bool mono = p.gamma >= 0.0 && fin[F_THETA] >= 0.0;
    for (int w = 0; w < W; ++w)
      if (iin[lay.i_lane + L_MODE * W + w] == 2)
        mono = mono && fin[lay.f_lane + L_C2 * W + w] >= 0.0 &&
               fin[lay.f_lane + L_K1 * W + w] >= 0.0;
    s_mono = mono;
  }
  // each lane's rows by state and its free slots, from the input state
  // once a launch
  for (int w = warp; w < W; w += nw) {
    long long c1 = 0, c2 = 0, c3 = 0;
    for (int s0 = 0; s0 < S.fw * 64; s0 += 32) {
      const int s = s0 + lane;
      const long long st =
          s < B ? iin[lay.i_row + static_cast<size_t>(w) * B + s] : -1;
      c1 += st == 1;
      c2 += st == 2;
      c3 += st == 3;
      const unsigned fr = __ballot_sync(kFull, st == 0);
      if (lane == 0) {
        unsigned long long& word =
            S.free[static_cast<size_t>(w) * S.fw + (s0 >> 6)];
        word = (s0 & 63) ? word | (static_cast<unsigned long long>(fr) << 32)
                         : static_cast<unsigned long long>(fr);
      }
    }
    c1 = warp_sum(c1);
    c2 = warp_sum(c2);
    c3 = warp_sum(c3);
    if (lane == 0) {
      S.agg(A_N1, w) = c1;
      S.agg(A_N2, w) = c2;
      S.agg(A_N3, w) = c3;
    }
  }
  __syncthreads();
  const double theta = s_theta;
  if (tid == 0) mark = clock64();

  for (;;) {
    bool mine = false;
    for (int w = tid; w < W; w += blockDim.x)
      mine = mine || S.agg(A_N1, w) + S.agg(A_N2, w) + S.agg(A_N3, w) > 0;
    const bool occupied = __syncthreads_or(mine);
    lap(S_OCC);
    if (!(sc[I_J] < sc[I_K]) ||
        (sc[I_IDX] >= n && sc[I_QLEN] == 0 && !occupied))
      break;
    const double t = s_t;
    __syncthreads();
    if (tid == 0) {  // admit arrivals <= t (the trace is sorted)
      long long idx = sc[I_IDX], qlen = sc[I_QLEN];
      while (idx < n && p.arrival[idx] <= t) {
        if (qlen >= p.Q) {
          sc[I_OVF] |= kOvfQueue;
          break;
        }
        S.q[qlen++] = idx++;
      }
      if (p.edf) {
        // priority, then deadline: insertion sort by the host's total
        // rank (unique, so any sort gives this order)
        for (long long i = 1; i < qlen; ++i) {
          const long long r = S.q[i];
          const long long key = p.rank_r[r];
          long long j = i;
          for (; j > 0 && p.rank_r[S.q[j - 1]] > key; --j) S.q[j] = S.q[j - 1];
          S.q[j] = r;
        }
      }
      sc[I_IDX] = idx;
      sc[I_QLEN] = qlen;
      s_busy = 0;
    }
    __syncthreads();
    lap(S_ADMIT);
    if (sc[I_QLEN] > 0) {
      for (int w = warp; w < W; w += nw)
        if (S.i(L_MODE, w) == 2)
          lane_aggregates(p, S, w, warp, lane, theta, al, tag_a);
      __syncthreads();
      lap(S_AGG);
      place_pass(p, S, sc, theta, s_nserv, s_mono, s_lo, s_tds, s_tf1, s_tpe,
                 stat);
      __syncthreads();
      lap(S_PLACE);
    }
    const double t_next = add(t, p.hb);
    for (int w = warp; w < W; w += nw) {
      const long long md = S.i(L_MODE, w);
      if (md == 2 || md == 3) advance_lane(p, S, w, warp, lane, t, t_next);
    }
    __syncthreads();
    lap(S_ADVANCE);
    // the host's billing replay from the lanes' counts: online lanes busy
    // with ongoing or new rows, and the first beat at which a draining lane
    // held nothing
    int busy = 0;
    for (int w = tid; w < W; w += blockDim.x) {
      const long long md = S.i(L_MODE, w);
      const long long loaded = S.agg(A_N1, w) + S.agg(A_N2, w);
      busy += md == 2 && loaded > 0;
      if (md == 3 && loaded + S.agg(A_N3, w) == 0 && S.i(L_EMPTY, w) == kBig)
        S.i(L_EMPTY, w) = sc[I_J];
    }
    if (busy) atomicAdd(&s_busy, busy);
    __syncthreads();
    if (tid == 0) {
      const long long bz = s_busy;
      sc[I_BUSY_PK] = bz > sc[I_BUSY_PK] ? bz : sc[I_BUSY_PK];
      sc[I_BUSY_FIN] = bz;
      sc[I_J] += 1;
      s_t = t_next;
      if (stat) stat[S_BEATS] += 1;
    }
    __syncthreads();
    lap(S_BILL);
  }
  // lanes and scalars back to the output state
  for (int k = tid; k < NF_LANES * W; k += blockDim.x)
    fo[lay.f_lane + k] = S.lf[k];
  for (int k = tid; k < NI_LANES * W; k += blockDim.x)
    io[lay.i_lane + k] = S.li[k];
  if (tid == 0) {
    fo[F_T] = s_t;
    fo[F_THETA] = s_theta;
    for (int k = 0; k < NI_SCALARS; ++k) io[k] = sc[k];
  }
  if (stat) {
    __syncthreads();
    if (tid == 0) {
      stat[S_CYCLES] = clock64() - t_begin;
      long long* out = p.stats + static_cast<size_t>(c) * NSTAT;
      for (int k = 0; k < NSTAT; ++k)
        out[k] = k == S_MEMBERS_MAX ? (stat[k] > out[k] ? stat[k] : out[k])
                                    : out[k] + stat[k];
    }
  }
}

// The global scratch of a candidate's member memory: none where it fits in
// shared memory beside the lanes.
size_t global_member_bytes(int W, int B) {
  const size_t lists = member_bytes(W, B, W < kMaxWarps ? W : kMaxWarps);
  return lane_bytes(W) + lists <= kMaxSmem - kStaticSmem ? 0 : lists;
}

}  // namespace

extern "C" long long fastsim_chunk_scratch_bytes(int W, int B) {
  if (W < 1 || B < 1) return 0;
  return static_cast<long long>(global_member_bytes(W, B));
}

extern "C" int fastsim_chunk_launch(
    const void* arrival, const void* l_in, const void* l_real,
    const void* rank_r, const void* ttft_r, const void* atgt_r,
    const void* s_lo, const void* s_f, const void* fin, const void* iin,
    void* fout, void* iout, void* scratch, void* stats, int n, int W, int B,
    int Q, int C, double hb, double gamma, double ttft, double atgt,
    int policy, int edf, int tagged, void* stream) {
  const int nw = W < kMaxWarps ? W : kMaxWarps;
  if (n < 1 || W < 1 || B < 1 || Q < 1 || C < 1 || policy < 0 ||
      policy > 2 || lane_bytes(W) > kMaxSmem - kStaticSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  // the member lists in shared memory where they fit beside the lanes,
  // else in the wrapper's global scratch
  const size_t global = global_member_bytes(W, B);
  if (global > 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      global > 0 ? lane_bytes(W) : lane_bytes(W) + member_bytes(W, B, nw);
  const cudaError_t attr = cudaFuncSetAttribute(
      chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Params p;
  p.arrival = static_cast<const double*>(arrival);
  p.l_in = static_cast<const long long*>(l_in);
  p.l_real = static_cast<const long long*>(l_real);
  p.rank_r = static_cast<const long long*>(rank_r);
  p.ttft_r = static_cast<const double*>(ttft_r);
  p.atgt_r = static_cast<const double*>(atgt_r);
  p.s_lo = static_cast<const long long*>(s_lo);
  p.s_f = static_cast<const double*>(s_f);
  p.fin = static_cast<const double*>(fin);
  p.iin = static_cast<const long long*>(iin);
  p.fout = static_cast<double*>(fout);
  p.iout = static_cast<long long*>(iout);
  p.scratch = global > 0 ? static_cast<unsigned char*>(scratch) : nullptr;
  p.scratch_bytes = global;
  p.stats = static_cast<long long*>(stats);
  p.n = n;
  p.W = W;
  p.B = B;
  p.Q = Q;
  p.C = C;
  p.hb = hb;
  p.gamma = gamma;
  p.ttft = ttft;
  p.atgt = atgt;
  p.policy = policy;
  p.edf = edf;
  p.tagged = tagged;
  chunk_kernel<<<C, nw * 32, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
