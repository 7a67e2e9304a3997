// The C entry points of the port's kernels. Each kernel's source defines
// its own and includes this header, so the compiler holds the definitions
// to these declarations; `module.cu` binds them to Python. Pointers are
// device addresses; `stream` is a cudaStream_t. Each returns
// cudaGetLastError() after its launch (0 when it succeeded).
#pragma once

extern "C" {

// B1: one-token attention over a paged KV pool, split across CTAs
// (decode_attention/csrc); `part` is the splits' fp32 workspace
int paged_decode_launch(const void* q, const void* k_pages,
                        const void* v_pages, void* out,
                        const void* block_table, const void* lengths,
                        void* part, int B, int Hq, int Hkv, int D, int page,
                        int max_pages, int split_pages, float scale,
                        int bf16, void* stream);

// B2: causal/offset flash attention forward (flash_attention/csrc); lse
// (B, Hq, Sq) fp32 or null: each row's logsumexp, for the backward
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, const void* kv_len, int B,
                           int Sq, int Skv, int Hq, int Hkv, int D,
                           int q_offset, int causal, float scale, int block_q,
                           int bf16_in, void* stream);

// B2's backward, three passes (flash_attention/csrc/flash_attention_bwd.cu):
// lse is the forward's; dq_acc (B, Sq, Hq, D) fp32 (dq itself for fp32
// inputs) and delta (B, Hq, Sq) fp32 are its scratch
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, const void* kv_len, void* dq,
                               void* dk, void* dv, void* dq_acc, void* delta,
                               int B, int Sq, int Skv, int Hq, int Hkv, int D,
                               int q_offset, int causal, float scale,
                               int bf16_in, void* stream);

// B3: RMSNorm with an optional residual (rmsnorm/csrc)
int rmsnorm_launch(const void* x, const void* r, const void* w, void* y,
                   int rows, int d, float eps, int x_bf16, int w_bf16,
                   void* stream);

// B3's backward, two passes (rmsnorm/csrc/rmsnorm_bwd.cu): dx in x's type
// (also the residual's gradient), dw in w's type; part (ctas, d) fp32 is
// its scratch
int rmsnorm_bwd_launch(const void* x, const void* r, const void* w,
                       const void* dy, void* dx, void* dw, void* part,
                       int rows, int d, int ctas, float eps, int x_bf16,
                       int w_bf16, void* stream);

// B4: Mamba-2 SSD chunked scan, three passes (ssd_scan/csrc)
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* D,
                    const void* init, void* y, void* fin, void* st,
                    void* entry, void* cum, int B, int S, int H, int P, int G,
                    int N, int Q, int bf16, void* stream);

// B4's backward, six passes (ssd_scan/csrc/ssd_scan_bwd.cu): entry and cum
// are the forward's scratch; dfin may be null; gst, dBCh, rows and
// chunk_sums are its own fp32 scratch
int ssd_scan_bwd_launch(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* D,
                        const void* dy, const void* dfin, const void* entry,
                        const void* cum, void* dx, void* ddt, void* dA,
                        void* dBm, void* dCm, void* dD, void* dinit,
                        void* gst, void* dBCh, void* rows, void* chunk_sums,
                        int B, int S, int H, int P, int G, int N, int Q,
                        int bf16, void* stream);

// The Scenario API's whole-trace simulation core (fastsim/csrc): one CTA
// per candidate fleet size; `par` is (8, W) float64 per-worker parameters;
// `scratch` (C, whole_trace_scratch_bytes(n, W, B)) bytes; `stats` (C,
// ops.py's len(WHOLE_STATS)) int64, or null
int whole_trace_launch(const void* arrival, const void* l_in,
                       const void* l_real, const void* rank,
                       const void* ttft_r, const void* atgt_r,
                       const void* n_active, const void* par, void* out_lo,
                       void* out_f, void* beats, void* scratch, void* stats,
                       int n, int W, int B, int C, double hb, double horizon,
                       double theta, double gamma, double ttft, double atgt,
                       int aladdin, int edf, int tagged, void* stream);

// The global scratch a whole-trace launch needs for each candidate: the
// queue's two buffers of keys (16 B a request), then the lane state that
// does not fit in shared memory; 0 for arguments the kernel refuses
long long whole_trace_scratch_bytes(int n, int W, int B);

// The Scenario API's chunked simulation core (fastsim/csrc): one CTA per
// candidate; `fin`/`iin` are each candidate's packed state (float64 and
// int64 buffers, ops.py's chunk_layout), `fout`/`iout` the advanced state;
// `s_lo` (C, n) and `s_f` (C, 3, n) the re-entrant sinks; policy 0 aladdin,
// 1 jsq, 2 po2; `scratch` (C, fastsim_chunk_scratch_bytes(W, B)) bytes, or
// null when that is 0; `stats` (C, ops.py's len(STATS)) int64, or null
int fastsim_chunk_launch(const void* arrival, const void* l_in,
                         const void* l_real, const void* rank_r,
                         const void* ttft_r, const void* atgt_r,
                         const void* s_lo, const void* s_f, const void* fin,
                         const void* iin, void* fout, void* iout,
                         void* scratch, void* stats, int n, int W, int B,
                         int Q, int C, double hb, double gamma,
                         double ttft, double atgt, int policy, int edf,
                         int tagged, void* stream);

// The global scratch a chunk launch needs for each candidate's member lists:
// 0 where they fit in shared memory beside the lanes
long long fastsim_chunk_scratch_bytes(int W, int B);

}  // extern "C"
