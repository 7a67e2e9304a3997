// The kernel library as a CPython extension module (`_kernels`): the one
// binding of the kernels' C entry points (`launch.cuh`) to Python. Each
// METH_FASTCALL function reads its arguments as Python ints and floats,
// with none of ctypes' per-argument marshalling, launches, and raises
// RuntimeError when the launch returns a CUDA error. Only Python.h and the
// CUDA runtime are included, never PyTorch's headers, so the file builds in
// seconds; the interpreter's symbols resolve when the library is imported.
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <string.h>

#include "launch.cuh"

namespace {

// A launch's arguments, read before the launch by a format of one letter
// per argument: 'p' an address (a Python int, or None for null), 'i' an
// int, 'f' a float, 'd' a double. `ok` is false, with a Python error set,
// when the count or a value does not fit.
struct Args {
  union {
    void* p;
    int i;
    float f;
    double d;
  } v[32];
  bool ok = false;

  Args(PyObject* const* a, Py_ssize_t n, const char* fmt, const char* name) {
    const Py_ssize_t want = static_cast<Py_ssize_t>(strlen(fmt));
    if (n != want || want > 32) {
      PyErr_Format(PyExc_TypeError, "%s: %zd arguments expected, got %zd",
                   name, want, n);
      return;
    }
    for (Py_ssize_t k = 0; k < n; ++k) {
      if (fmt[k] == 'p') {
        v[k].p = a[k] == Py_None ? nullptr : PyLong_AsVoidPtr(a[k]);
      } else if (fmt[k] == 'i') {
        const long x = PyLong_AsLong(a[k]);
        if (!PyErr_Occurred() && (x < INT_MIN || x > INT_MAX))
          PyErr_Format(PyExc_OverflowError, "%s: argument %zd out of int "
                       "range", name, k);
        v[k].i = static_cast<int>(x);
      } else if (fmt[k] == 'd') {
        v[k].d = PyFloat_AsDouble(a[k]);
      } else {
        v[k].f = static_cast<float>(PyFloat_AsDouble(a[k]));
      }
      if (PyErr_Occurred()) return;
    }
    ok = true;
  }
  void* p(int k) const { return v[k].p; }
  int i(int k) const { return v[k].i; }
  float f(int k) const { return v[k].f; }
  double d(int k) const { return v[k].d; }
};

PyObject* result(int err, const char* name) {
  if (err != 0)
    return PyErr_Format(PyExc_RuntimeError, "%s: CUDA launch failed (%d: %s)",
                        name, err,
                        cudaGetErrorString(static_cast<cudaError_t>(err)));
  Py_RETURN_NONE;
}

// paged_decode(q, k_pages, v_pages, out, block_table, lengths, part, B,
//              Hq, Hkv, D, page, max_pages, split_pages, scale, bf16,
//              stream)
PyObject* paged_decode(PyObject*, PyObject* const* a, Py_ssize_t n) {
  const char* name = "paged_decode_attention";
  const Args in(a, n, "pppppppiiiiiiifip", name);
  if (!in.ok) return nullptr;
  return result(paged_decode_launch(
                    in.p(0), in.p(1), in.p(2), in.p(3), in.p(4), in.p(5),
                    in.p(6), in.i(7), in.i(8), in.i(9), in.i(10), in.i(11),
                    in.i(12), in.i(13), in.f(14), in.i(15), in.p(16)),
                name);
}

// flash_attention(q, k, v, o, lse or None, kv_len or None, part or None,
//                 B, Sq, Skv, Hq, Hkv, D, q_offset, causal, scale, block_q,
//                 kv_splits, bf16, stream)
PyObject* flash_attention(PyObject*, PyObject* const* a, Py_ssize_t n) {
  const char* name = "flash_attention";
  const Args in(a, n, "pppppppiiiiiiiifiiip", name);
  if (!in.ok) return nullptr;
  return result(flash_attention_launch(
                    in.p(0), in.p(1), in.p(2), in.p(3), in.p(4), in.p(5),
                    in.p(6), in.i(7), in.i(8), in.i(9), in.i(10), in.i(11),
                    in.i(12), in.i(13), in.i(14), in.f(15), in.i(16),
                    in.i(17), in.i(18), in.p(19)),
                name);
}

// flash_attention_bwd(q, k, v, o, dout, lse, kv_len or None, dq, dk, dv,
//                     dq_acc, delta, B, Sq, Skv, Hq, Hkv, D, q_offset,
//                     causal, scale, bf16, stream)
PyObject* flash_attention_bwd(PyObject*, PyObject* const* a, Py_ssize_t n) {
  const char* name = "flash_attention_backward";
  const Args in(a, n, "ppppppppppppiiiiiiiifip", name);
  if (!in.ok) return nullptr;
  return result(flash_attention_bwd_launch(
                    in.p(0), in.p(1), in.p(2), in.p(3), in.p(4), in.p(5),
                    in.p(6), in.p(7), in.p(8), in.p(9), in.p(10), in.p(11),
                    in.i(12), in.i(13), in.i(14), in.i(15), in.i(16),
                    in.i(17), in.i(18), in.i(19), in.f(20), in.i(21),
                    in.p(22)),
                name);
}

// rmsnorm(x, r or None, w, y, rows, d, eps, x_bf16, w_bf16, stream)
PyObject* rmsnorm(PyObject*, PyObject* const* a, Py_ssize_t n) {
  const char* name = "rmsnorm";
  const Args in(a, n, "ppppiifiip", name);
  if (!in.ok) return nullptr;
  return result(rmsnorm_launch(in.p(0), in.p(1), in.p(2), in.p(3), in.i(4),
                               in.i(5), in.f(6), in.i(7), in.i(8), in.p(9)),
                name);
}

// rmsnorm_bwd(x, r or None, w, dy, dx, dw, part, rows, d, ctas, eps, x_bf16,
//             w_bf16, stream)
PyObject* rmsnorm_bwd(PyObject*, PyObject* const* a, Py_ssize_t n) {
  const char* name = "rmsnorm_backward";
  const Args in(a, n, "pppppppiiifiip", name);
  if (!in.ok) return nullptr;
  return result(rmsnorm_bwd_launch(in.p(0), in.p(1), in.p(2), in.p(3),
                                   in.p(4), in.p(5), in.p(6), in.i(7),
                                   in.i(8), in.i(9), in.f(10), in.i(11),
                                   in.i(12), in.p(13)),
                name);
}

// ssd_scan(x, dt, A, Bm, Cm, D, init or None, y, fin, st, entry, cum, B, S,
//          H, P, G, N, Q, bf16, stream)
PyObject* ssd_scan(PyObject*, PyObject* const* a, Py_ssize_t n) {
  const char* name = "ssd_scan";
  const Args in(a, n, "ppppppppppppiiiiiiiip", name);
  if (!in.ok) return nullptr;
  return result(ssd_scan_launch(
                    in.p(0), in.p(1), in.p(2), in.p(3), in.p(4), in.p(5),
                    in.p(6), in.p(7), in.p(8), in.p(9), in.p(10), in.p(11),
                    in.i(12), in.i(13), in.i(14), in.i(15), in.i(16),
                    in.i(17), in.i(18), in.i(19), in.p(20)),
                name);
}

// ssd_scan_bwd(x, dt, A, Bm, Cm, D, dy, dfin or None, entry, cum, dx, ddt,
//              dA, dBm, dCm, dD, dinit, gst, dBCh, rows, chunk_sums, B, S,
//              H, P, G, N, Q, hs, bf16, stream)
PyObject* ssd_scan_bwd(PyObject*, PyObject* const* a, Py_ssize_t n) {
  const char* name = "ssd_scan_bwd";
  const Args in(a, n, "pppppppppppppppppppppiiiiiiiiip", name);
  if (!in.ok) return nullptr;
  return result(ssd_scan_bwd_launch(
                    in.p(0), in.p(1), in.p(2), in.p(3), in.p(4), in.p(5),
                    in.p(6), in.p(7), in.p(8), in.p(9), in.p(10), in.p(11),
                    in.p(12), in.p(13), in.p(14), in.p(15), in.p(16),
                    in.p(17), in.p(18), in.p(19), in.p(20), in.i(21),
                    in.i(22), in.i(23), in.i(24), in.i(25), in.i(26),
                    in.i(27), in.i(28), in.i(29), in.p(30)),
                name);
}

// whole_trace(arrival, l_in, l_real, rank, ttft_r, atgt_r, n_active, par,
//             out_lo, out_f, beats, scratch, stats or None, n, W, B, C, hb,
//             horizon, theta, gamma, ttft, atgt, aladdin, edf, tagged,
//             stream)
PyObject* whole_trace(PyObject*, PyObject* const* a, Py_ssize_t n) {
  const char* name = "whole_trace";
  const Args in(a, n, "pppppppppppppiiiiddddddiiip", name);
  if (!in.ok) return nullptr;
  return result(whole_trace_launch(
                    in.p(0), in.p(1), in.p(2), in.p(3), in.p(4), in.p(5),
                    in.p(6), in.p(7), in.p(8), in.p(9), in.p(10), in.p(11),
                    in.p(12), in.i(13), in.i(14), in.i(15), in.i(16),
                    in.d(17), in.d(18), in.d(19), in.d(20), in.d(21),
                    in.d(22), in.i(23), in.i(24), in.i(25), in.p(26)),
                name);
}

// fastsim_chunk(arrival, l_in, l_real, rank_r, ttft_r, atgt_r, s_lo, s_f,
//               fin, iin, fout, iout, scratch or None, stats or None, n, W,
//               B, Q, C, hb, gamma, ttft, atgt, policy, edf, tagged, stream)
PyObject* fastsim_chunk(PyObject*, PyObject* const* a, Py_ssize_t n) {
  const char* name = "fastsim_chunk";
  const Args in(a, n, "ppppppppppppppiiiiiddddiiip", name);
  if (!in.ok) return nullptr;
  return result(fastsim_chunk_launch(
                    in.p(0), in.p(1), in.p(2), in.p(3), in.p(4), in.p(5),
                    in.p(6), in.p(7), in.p(8), in.p(9), in.p(10), in.p(11),
                    in.p(12), in.p(13), in.i(14), in.i(15), in.i(16),
                    in.i(17), in.i(18), in.d(19), in.d(20), in.d(21),
                    in.d(22), in.i(23), in.i(24), in.i(25), in.p(26)),
                name);
}

// fastsim_chunk_scratch(W, B): the bytes of global scratch a chunk launch
// needs for each candidate, 0 where its member lists fit in shared memory
PyObject* fastsim_chunk_scratch(PyObject*, PyObject* const* a,
                                Py_ssize_t n) {
  const Args in(a, n, "ii", "fastsim_chunk_scratch");
  if (!in.ok) return nullptr;
  return PyLong_FromLongLong(fastsim_chunk_scratch_bytes(in.i(0), in.i(1)));
}

// whole_trace_scratch(n, W, B): the bytes of global scratch a whole-trace
// launch needs for each candidate
PyObject* whole_trace_scratch(PyObject*, PyObject* const* a, Py_ssize_t n) {
  const Args in(a, n, "iii", "whole_trace_scratch");
  if (!in.ok) return nullptr;
  return PyLong_FromLongLong(
      whole_trace_scratch_bytes(in.i(0), in.i(1), in.i(2)));
}

template <PyObject* (*F)(PyObject*, PyObject* const*, Py_ssize_t)>
PyCFunction fastcall() {
  return reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)()>(F));
}

PyMethodDef methods[] = {
    {"paged_decode", fastcall<paged_decode>(), METH_FASTCALL,
     "Launch kernel B1; raises RuntimeError on a CUDA error."},
    {"flash_attention", fastcall<flash_attention>(), METH_FASTCALL,
     "Launch kernel B2; raises RuntimeError on a CUDA error."},
    {"flash_attention_bwd", fastcall<flash_attention_bwd>(), METH_FASTCALL,
     "Launch kernel B2's backward; raises RuntimeError on a CUDA error."},
    {"rmsnorm", fastcall<rmsnorm>(), METH_FASTCALL,
     "Launch kernel B3; raises RuntimeError on a CUDA error."},
    {"rmsnorm_bwd", fastcall<rmsnorm_bwd>(), METH_FASTCALL,
     "Launch kernel B3's backward; raises RuntimeError on a CUDA error."},
    {"ssd_scan", fastcall<ssd_scan>(), METH_FASTCALL,
     "Launch kernel B4; raises RuntimeError on a CUDA error."},
    {"ssd_scan_bwd", fastcall<ssd_scan_bwd>(), METH_FASTCALL,
     "Launch kernel B4's backward; raises RuntimeError on a CUDA error."},
    {"whole_trace", fastcall<whole_trace>(), METH_FASTCALL,
     "Launch the whole-trace simulation core; raises RuntimeError on a "
     "CUDA error."},
    {"whole_trace_scratch", fastcall<whole_trace_scratch>(), METH_FASTCALL,
     "The bytes of global scratch a whole-trace launch needs for each "
     "candidate."},
    {"fastsim_chunk", fastcall<fastsim_chunk>(), METH_FASTCALL,
     "Launch the chunked simulation core; raises RuntimeError on a CUDA "
     "error."},
    {"fastsim_chunk_scratch", fastcall<fastsim_chunk_scratch>(),
     METH_FASTCALL,
     "The bytes of global scratch a chunked-core launch needs for each "
     "candidate."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module_def = {PyModuleDef_HEAD_INIT, "_kernels", nullptr, -1,
                          methods};

}  // namespace

extern "C" PyMODINIT_FUNC PyInit__kernels() {
  return PyModule_Create(&module_def);
}
