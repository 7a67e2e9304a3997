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
// slot a decode iteration. The loop is sequential by nature: beats follow
// each other, and within a beat each queued request is placed after the one
// before it, against the aggregates that placement changed. So the kernel is
// bound by latency, beats x (sequential placements + the longest worker's
// segment loop), each step a chain of dependent shared-memory reads,
// shuffles and fp64 adds.
//
// Design:
// - one CTA per candidate fleet size (the reference's vmap), all candidates
//   in parallel on the SMs; `n_active[c]` workers of the W lanes are alive;
// - lane state (W x B slots: request id, l_in, l_real, l_out, t_decode_spent,
//   first-token and finish times, active/started flags) lives in dynamic
//   shared memory, above 48 KB when W x B is large (W 40 x B 32 is 58 KB),
//   hence cudaFuncSetAttribute; trace-sized arrays (arrival, lengths, ranks,
//   SLO budgets, the queue, the outputs) stay in global memory;
// - warp 0 admits arrivals, keeps the backlog in rank order (EDF), and runs
//   the placement pass: for each queued request a warp-wide argmax of the
//   capacity norm over the feasible workers (aladdin) or argmin of the batch
//   (jsq), ties to the lowest index as jnp.argmax/argmin;
// - then every warp advances its lanes (lane w on warp w % warps): the
//   reductions over a lane's slots are warp shuffles, the decode segment's
//   dependent adds run on every thread of the warp alike;
// - the beat clock, the event skip and the beat count are thread 0's; one
//   synchronisation with the host, at the end, when the outputs are read.
//
// Numerics are those of the numpy core, which is bit for bit equal to the
// reference engine: every add and multiply through __dadd_rn/__dmul_rn (nvcc
// never contracts those into a fused multiply-add), sequential
// left-associated sums of floats, `k2*C + c2*b + c3` as
// ((k2*C) + (c2*b)) + c3, a decode segment closed at every beat end (also at
// those the event skip covers), and the capacity norm through CPython's
// math.hypot algorithm (`py_hypot`), so best-fit ranks workers as the numpy
// core does. Integer sums (batch, context, new tokens) are exact in any
// order.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kMaxWarps = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // what a CTA may use on Hopper

__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dvd(double a, double b) {
  return __ddiv_rn(a, b);
}
// Python's min(a, b) and max(a, 0.0) on numbers that are never NaN
__device__ __forceinline__ double pmin(double a, double b) {
  return b < a ? b : a;
}
__device__ __forceinline__ double max0(double a) { return 0.0 > a ? 0.0 : a; }

// CPython's math.hypot for two finite non-negative numbers (vector_norm in
// Modules/mathmodule.c): scale by a power of two, add the exact squares as
// double-length values into a compensated sum, take the square root and
// apply one correction. The fused multiply-adds here give exact low parts
// of products, which is what CPython's double-length multiply computes.
__device__ double py_hypot(double a, double b) {
  const double mx = a < b ? b : a;
  if (mx == 0.0) return mx;
  int e;
  frexp(mx, &e);
  const double scale = ldexp(1.0, -e);
  double csum = 1.0, f1 = 0.0, f2 = 0.0;
  const double xs[2] = {mul(a, scale), mul(b, scale)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const double ph = mul(xs[i], xs[i]);
    const double pl = __fma_rn(xs[i], xs[i], -ph);
    const double hi = add(csum, ph);
    f2 = add(f2, add(sub(csum, hi), ph));
    csum = hi;
    f1 = add(f1, pl);
  }
  double h = __dsqrt_rn(add(sub(csum, 1.0), add(f1, f2)));
  const double ph = mul(-h, h);
  const double pl = __fma_rn(-h, h, -ph);
  const double hi = add(csum, ph);
  f2 = add(f2, add(sub(csum, hi), ph));
  csum = hi;
  f1 = add(f1, pl);
  h = add(h, dvd(add(sub(csum, 1.0), add(f1, f2)), mul(2.0, h)));
  return dvd(h, scale);
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ long long warp_min(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long x = __shfl_xor_sync(kFull, v, o);
    v = x < v ? x : v;
  }
  return v;
}
__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = pmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
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
  int* queue;         // (C, n) scratch
  int n, W, B, C;
  double hb, horizon, theta, gamma, ttft, atgt;
  int aladdin, edf, tagged;
};

// The CTA's dynamic shared memory: per slot (W x B), per lane (W) and per
// warp. Doubles first, then 8-byte, 4-byte and 1-byte arrays.
struct Lanes {
  double *tds, *tf1, *tfn;                                   // slots
  double *t, *k1, *c1, *k2, *c2, *c3, *mbn, *cmn;            // lanes
  double *wctx, *dbud, *dbud_t, *amin, *tmin;                // lanes
  long long* newsum;                                         // lanes
  int *mem, *li, *lr, *lo;                                   // slots
  int *maxb, *cnt;                                           // lanes
  int* jfin;                                                 // warps
  unsigned char *act, *sta;                                  // slots
  unsigned char* busy;                                       // warps

  __host__ __device__ static size_t bytes(int W, int B, int nw) {
    const size_t wb = static_cast<size_t>(W) * B;
    return 8 * (3 * wb + 14 * static_cast<size_t>(W)) +
           4 * (4 * wb + 2 * static_cast<size_t>(W) + nw) + 2 * wb + nw;
  }

  __device__ Lanes(unsigned char* base, int W, int B, int nw) {
    const size_t wb = static_cast<size_t>(W) * B;
    double* d = reinterpret_cast<double*>(base);
    tds = d; tf1 = d + wb; tfn = d + 2 * wb;
    d += 3 * wb;
    double** lane_d[] = {&t, &k1, &c1, &k2, &c2, &c3, &mbn, &cmn,
                         &wctx, &dbud, &dbud_t, &amin, &tmin};
    for (double** p : lane_d) { *p = d; d += W; }
    newsum = reinterpret_cast<long long*>(d);
    int* i = reinterpret_cast<int*>(newsum + W);
    mem = i; li = i + wb; lr = i + 2 * wb; lo = i + 3 * wb;
    i += 4 * wb;
    maxb = i; cnt = i + W; jfin = i + 2 * W;
    unsigned char* u = reinterpret_cast<unsigned char*>(i + 2 * W + nw);
    act = u; sta = u + wb; busy = u + 2 * wb;
  }
};

// Lane w's aggregates for the next placement pass (warp-wide): batch, new
// tokens, weighted context (summed in slot order by lane 0), constraint
// (d)'s budgets over the ongoing members and, for tagged traces, the
// strictest member budgets.
__device__ void lane_aggregates(const Params& p, Lanes& L, int w, int lane,
                                bool tag_a) {
  const int B = p.B;
  long long cnt = 0, newsum = 0;
  double slack = CUDART_INF, slack_t = CUDART_INF;
  double amin = CUDART_INF, tmin = CUDART_INF;
  for (int s = lane; s < B; s += 32) {
    const int k = w * B + s;
    if (!L.act[k]) continue;
    ++cnt;
    const int rid = L.mem[k];
    if (L.sta[k]) {
      const double m = static_cast<double>(L.lo[k] > 1 ? L.lo[k] - 1 : 0);
      slack = pmin(slack, sub(mul(p.atgt, m), L.tds[k]));
      if (tag_a) {
        double am = p.atgt_r[rid];
        am = am == CUDART_INF ? p.atgt : am;
        slack_t = pmin(slack_t, sub(mul(am, m), L.tds[k]));
      }
    } else {
      newsum += L.li[k];
      if (tag_a) tmin = pmin(tmin, p.ttft_r[rid]);
    }
    if (tag_a) amin = pmin(amin, p.atgt_r[rid]);
  }
  cnt = warp_sum(cnt);
  newsum = warp_sum(newsum);
  slack = warp_min(slack);
  slack_t = warp_min(slack_t);
  amin = warp_min(amin);
  tmin = warp_min(tmin);
  if (lane == 0) {
    double wctx = 0.0;
    for (int s = 0; s < B; ++s) {
      const int k = w * B + s;
      if (L.act[k])
        wctx = add(wctx, add(static_cast<double>(L.li[k]),
                             mul(p.gamma, static_cast<double>(L.lr[k]))));
    }
    L.wctx[w] = wctx;
    L.cnt[w] = static_cast<int>(cnt);
    L.newsum[w] = newsum;
    L.dbud[w] = mul(p.theta, max0(slack));
    L.dbud_t[w] = mul(p.theta, max0(slack_t));
    L.amin[w] = amin;
    L.tmin[w] = tmin;
  }
}

// The placement pass over the backlog q[0, qlen) (warp 0). Returns the
// number still queued; they keep their order at the head of q.
__device__ int place_pass(const Params& p, Lanes& L, int* q, int qlen,
                          long long na, int lane, bool tag_a) {
  const int W = p.W, B = p.B;
  int keep = 0;
  for (int i = 0; i < qlen; ++i) {
    const int rid = q[i];
    const long long liv = p.l_in[rid], lrv = p.l_real[rid];
    const double v = add(static_cast<double>(liv),
                         mul(p.gamma, static_cast<double>(lrv)));
    const double ar = tag_a ? p.atgt_r[rid] : 0.0;
    const double tr = tag_a ? p.ttft_r[rid] : 0.0;
    const bool ct = tag_a && ar != CUDART_INF;
    // this thread's best over workers lane, lane + 32, ...: larger key
    // wins (the capacity norm, or minus the batch for jsq), then the
    // lower index
    int best = INT32_MAX;
    double key = -CUDART_INF;
    for (int w = lane; w < W; w += 32) {
      const int bpost = L.cnt[w] + 1;
      if (!(w < na && bpost <= L.maxb[w])) continue;
      double kw;
      if (p.aladdin) {
        double a_eff = p.atgt, t_eff = p.ttft, d_eff = L.dbud[w];
        if (ct) {  // an untagged candidate takes the scalar branch
          const double a0 = pmin(L.amin[w], ar);
          a_eff = a0 == CUDART_INF ? p.atgt : a0;
          const double t0 = pmin(L.tmin[w], tr);
          t_eff = t0 == CUDART_INF ? p.ttft : t0;
          d_eff = L.dbud_t[w];
        }
        const double budget =
            L.k2[w] > 0.0
                ? max0(dvd(sub(sub(a_eff, L.c3[w]),
                               mul(L.c2[w], static_cast<double>(bpost))),
                           L.k2[w]))
                : CUDART_INF;
        const double pre_t = add(
            mul(L.k1[w], static_cast<double>(L.newsum[w] + liv)), L.c1[w]);
        if (!(add(L.wctx[w], v) <= mul(p.theta, budget) && pre_t <= t_eff &&
              pre_t <= d_eff))
          continue;
        kw = py_hypot(dvd(static_cast<double>(L.cnt[w]), L.mbn[w]),
                      dvd(L.wctx[w], L.cmn[w]));
      } else {
        kw = -static_cast<double>(L.cnt[w]);
      }
      if (best == INT32_MAX || kw > key) {
        best = w;
        key = kw;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int bo = __shfl_xor_sync(kFull, best, o);
      const double ko = __shfl_xor_sync(kFull, key, o);
      if (bo != INT32_MAX &&
          (best == INT32_MAX || ko > key || (ko == key && bo < best))) {
        best = bo;
        key = ko;
      }
    }
    if (best == INT32_MAX) {  // stays queued, FIFO order kept
      if (lane == 0) q[keep] = rid;
      ++keep;
      __syncwarp();
      continue;
    }
    const int w = best;
    int slot = -1;  // the first free slot of worker w
    for (int s0 = 0; s0 < B && slot < 0; s0 += 32) {
      const unsigned free =
          __ballot_sync(kFull, s0 + lane < B && !L.act[w * B + s0 + lane]);
      if (free) slot = s0 + __ffs(free) - 1;
    }
    if (lane == 0) {
      const int k = w * B + slot;
      L.mem[k] = rid;
      L.act[k] = 1;
      L.sta[k] = 0;
      L.li[k] = static_cast<int>(liv);
      L.lr[k] = static_cast<int>(lrv);
      L.lo[k] = 0;
      L.tds[k] = 0.0;
      L.tf1[k] = CUDART_NAN;
      L.tfn[k] = CUDART_NAN;
      L.cnt[w] += 1;
      L.newsum[w] += liv;
      L.wctx[w] = add(L.wctx[w], v);
      if (tag_a) {
        L.amin[w] = pmin(L.amin[w], ar);
        L.tmin[w] = pmin(L.tmin[w], tr);
      }
    }
    __syncwarp();
  }
  return keep;
}

// Lane w through the k_steps beats that end at t + hb, t + hb + hb, ...,
// t_next (warp-wide). Each beat is the worker's advance_to(beat end):
// a joint prefill of the new members (decode stalls), else a decode segment
// with the batch fixed until the next finish or the beat end. Finishers
// are written out at once. Returns the number of the last beat in which a
// request finished (0 for none).
__device__ int advance_lane(const Params& p, Lanes& L, int w, int lane,
                            double t, int k_steps, double t_next,
                            int64_t* out_lo, double* out_tds,
                            double* out_tf1, double* out_tfn) {
  const int B = p.B;
  const double k1 = L.k1[w], c1 = L.c1[w], k2 = L.k2[w], c2 = L.c2[w],
               c3 = L.c3[w];
  double tl = L.t[w];
  int j_fin = 0;
  double bj = t;
  for (int j = 1; j <= k_steps; ++j) {
    bj = add(bj, p.hb);
    bool fin = false;
    while (tl < bj) {
      bool mine_new = false;
      long long tot_in = 0;
      for (int s = lane; s < B; s += 32) {
        const int k = w * B + s;
        if (L.act[k] && !L.sta[k]) {
          mine_new = true;
          tot_in += L.li[k];
        }
      }
      if (__any_sync(kFull, mine_new)) {
        tot_in = warp_sum(tot_in);
        const double dur_p = add(mul(k1, static_cast<double>(tot_in)), c1);
        const double t_pre = add(tl, dur_p);
        for (int s = lane; s < B; s += 32) {
          const int k = w * B + s;
          if (!L.act[k]) continue;
          if (L.sta[k]) {
            L.tds[k] = add(L.tds[k], dur_p);
          } else {
            L.tf1[k] = t_pre;
            L.lo[k] = 1;
            L.sta[k] = 1;
          }
        }
        tl = t_pre;
        continue;
      }
      long long b = 0, c0 = 0, n_fin = INT64_MAX;
      for (int s = lane; s < B; s += 32) {
        const int k = w * B + s;
        if (!L.act[k]) continue;
        ++b;
        c0 += L.li[k] + L.lo[k];
        const long long left = L.lr[k] - L.lo[k] > 1 ? L.lr[k] - L.lo[k] : 1;
        n_fin = left < n_fin ? left : n_fin;
      }
      b = warp_sum(b);
      if (b == 0) {
        tl = bj;
        continue;
      }
      c0 = warp_sum(c0);
      n_fin = warp_min(n_fin);
      const double cb = mul(c2, static_cast<double>(b));
      long long k = 0;
      double td = tl, seg = 0.0;
      while (k < n_fin && td < bj) {
        const double dur =
            add(add(mul(k2, static_cast<double>(c0 + k * b)), cb), c3);
        ++k;
        td = add(td, dur);
        seg = add(seg, dur);
      }
      bool mine_fin = false;
      for (int s = lane; s < B; s += 32) {
        const int x = w * B + s;
        if (!L.act[x]) continue;
        L.lo[x] += static_cast<int>(k);
        L.tds[x] = add(L.tds[x], seg);
        if (L.lo[x] >= L.lr[x]) {
          L.tfn[x] = td;
          L.act[x] = 0;
          const int rid = L.mem[x];
          out_lo[rid] = L.lo[x];
          out_tds[rid] = L.tds[x];
          out_tf1[rid] = L.tf1[x];
          out_tfn[rid] = td;
          mine_fin = true;
        }
      }
      fin = __any_sync(kFull, mine_fin) || fin;
      tl = td;
    }
    if (fin) j_fin = j;
    bool mine_busy = false;
    for (int s = lane; s < B; s += 32) mine_busy = mine_busy || L.act[w * B + s];
    if (!__any_sync(kFull, mine_busy)) {  // idle: jump to the last beat end
      tl = t_next > tl ? t_next : tl;
      break;
    }
  }
  __syncwarp();
  if (lane == 0) L.t[w] = tl;
  return j_fin;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    whole_trace_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_t, s_tnext;
  __shared__ int s_idx, s_qlen, s_ksteps, s_any;
  __shared__ long long s_beats;

  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int n = p.n, W = p.W, B = p.B;
  const size_t cn = static_cast<size_t>(c) * n, Cn = static_cast<size_t>(p.C) * n;
  int64_t* out_lo = p.out_lo + cn;
  double* out_tds = p.out_f + cn;
  double* out_tf1 = p.out_f + Cn + cn;
  double* out_tfn = p.out_f + 2 * Cn + cn;
  int* q = p.queue + cn;
  const long long na = p.n_active[c];
  const bool tag_a = p.tagged && p.aladdin;
  Lanes L(smem, W, B, nw);

  for (int i = tid; i < n; i += blockDim.x) {
    out_lo[i] = 0;
    out_tds[i] = 0.0;
    out_tf1[i] = CUDART_NAN;
    out_tfn[i] = CUDART_NAN;
  }
  for (int k = tid; k < W * B; k += blockDim.x) {
    L.mem[k] = -1;
    L.li[k] = L.lr[k] = L.lo[k] = 0;
    L.tds[k] = 0.0;
    L.tf1[k] = L.tfn[k] = CUDART_NAN;
    L.act[k] = L.sta[k] = 0;
  }
  for (int w = tid; w < W; w += blockDim.x) {
    L.t[w] = 0.0;
    L.k1[w] = p.par[w];
    L.c1[w] = p.par[W + w];
    L.k2[w] = p.par[2 * W + w];
    L.c2[w] = p.par[3 * W + w];
    L.c3[w] = p.par[4 * W + w];
    L.mbn[w] = p.par[5 * W + w];
    L.cmn[w] = p.par[6 * W + w];
    L.maxb[w] = static_cast<int>(p.par[7 * W + w]);
  }
  if (tid == 0) {
    s_t = 0.0;
    s_idx = s_qlen = s_any = 0;
    s_beats = 0;
  }
  __syncthreads();
  for (int w = warp; w < W; w += nw) lane_aggregates(p, L, w, lane, tag_a);
  __syncthreads();

  for (;;) {
    const double t = s_t;
    if (!(t < p.horizon) || (s_idx >= n && s_qlen == 0 && !s_any)) break;
    if (warp == 0) {
      int idx = s_idx, qlen = s_qlen;
      if (lane == 0) {
        const int q0 = qlen;
        while (idx < n && p.arrival[idx] <= t) q[qlen++] = idx++;
        if (p.edf) {
          // the backlog q[0, q0) is in rank order already: insert the new
          // arrivals (ranks are unique, so any sort gives this order)
          for (int i = q0; i < qlen; ++i) {
            const int r = q[i];
            const int64_t key = p.rank[r];
            int j = i;
            for (; j > 0 && p.rank[q[j - 1]] > key; --j) q[j] = q[j - 1];
            q[j] = r;
          }
        }
      }
      idx = __shfl_sync(kFull, idx, 0);
      qlen = __shfl_sync(kFull, qlen, 0);
      __syncwarp();
      qlen = place_pass(p, L, q, qlen, na, lane, tag_a);
      if (lane == 0) {
        // event skip: with an empty queue, step the beat clock with the
        // same sequential adds up to the next arrival
        const bool can_skip = qlen == 0;
        const double next_arr = idx < n ? p.arrival[idx] : CUDART_INF;
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
    __syncthreads();
    const double t_next = s_tnext;
    const int k_steps = s_ksteps;
    int jf = 0;
    bool busy = false;
    for (int w = warp; w < W; w += nw) {
      const int j = advance_lane(p, L, w, lane, t, k_steps, t_next, out_lo,
                                 out_tds, out_tf1, out_tfn);
      jf = j > jf ? j : jf;
      lane_aggregates(p, L, w, lane, tag_a);
      __syncwarp();
      busy = busy || L.cnt[w] > 0;
    }
    if (lane == 0) {
      L.jfin[warp] = jf;
      L.busy[warp] = busy;
    }
    __syncthreads();
    if (tid == 0) {
      int jmax = 0;
      bool any = false;
      for (int i = 0; i < nw; ++i) {
        jmax = L.jfin[i] > jmax ? L.jfin[i] : jmax;
        any = any || L.busy[i];
      }
      // the final drain runs to the horizon: count its beats up to the one
      // in which the last request finished, where a stepwise loop stops
      const bool drained = s_idx >= n && !any;
      s_beats += drained && k_steps > 1 ? (jmax > 1 ? jmax : 1) : k_steps;
      s_any = any;
      s_t = t_next;
    }
    __syncthreads();
  }
  // flush still-running rows (partial clocks)
  for (int w = warp; w < W; w += nw) {
    for (int s = lane; s < B; s += 32) {
      const int k = w * B + s;
      if (!L.act[k]) continue;
      const int rid = L.mem[k];
      out_lo[rid] = L.lo[k];
      out_tds[rid] = L.tds[k];
      out_tf1[rid] = L.tf1[k];
      out_tfn[rid] = L.tfn[k];
    }
  }
  if (tid == 0) p.beats[c] = s_beats;
}

}  // namespace

extern "C" int whole_trace_launch(
    const void* arrival, const void* l_in, const void* l_real,
    const void* rank, const void* ttft_r, const void* atgt_r,
    const void* n_active, const void* par, void* out_lo, void* out_f,
    void* beats, void* queue, int n, int W, int B, int C, double hb,
    double horizon, double theta, double gamma, double ttft, double atgt,
    int aladdin, int edf, int tagged, void* stream) {
  const int nw = W < kMaxWarps ? W : kMaxWarps;
  const size_t bytes = Lanes::bytes(W, B, nw);
  if (n < 1 || W < 1 || B < 1 || C < 1 || bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      whole_trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
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
  p.queue = static_cast<int*>(queue);
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
  whole_trace_kernel<<<C, nw * 32, bytes,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
