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

// B2: causal/offset flash attention forward (flash_attention/csrc)
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const void* kv_len, int B, int Sq,
                           int Skv, int Hq, int Hkv, int D, int q_offset,
                           int causal, float scale, int block_q, int bf16_in,
                           void* stream);

// B3: RMSNorm with an optional residual (rmsnorm/csrc)
int rmsnorm_launch(const void* x, const void* r, const void* w, void* y,
                   int rows, int d, float eps, int x_bf16, int w_bf16,
                   void* stream);

// B4: Mamba-2 SSD chunked scan, three passes (ssd_scan/csrc)
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* D,
                    const void* init, void* y, void* fin, void* st,
                    void* entry, void* cum, int B, int S, int H, int P, int G,
                    int N, int Q, int bf16, void* stream);

// The Scenario API's whole-trace simulation core (fastsim/csrc): one CTA
// per candidate fleet size; `par` is (8, W) float64 per-worker parameters
int whole_trace_launch(const void* arrival, const void* l_in,
                       const void* l_real, const void* rank,
                       const void* ttft_r, const void* atgt_r,
                       const void* n_active, const void* par, void* out_lo,
                       void* out_f, void* beats, void* queue, int n, int W,
                       int B, int C, double hb, double horizon, double theta,
                       double gamma, double ttft, double atgt, int aladdin,
                       int edf, int tagged, void* stream);

}  // extern "C"
