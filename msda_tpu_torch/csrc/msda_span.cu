// Span markers: empty kernels that mark where a layer begins and ends on the
// device, so that a CUDA graph replay's trace shows its layers.
//
// There is no Pallas original and nothing is computed.  A profiler span on
// the host (torch.profiler.record_function) runs once, during a graph's
// capture, and never in its replays; a kernel captured into the graph runs
// in every replay, at the device's own time.  So utils/profile.py's
// annotate launches msda_span<Name, begin> when it enters a layer's span
// under stream capture, and msda_span<Name, end> when it leaves it.  The
// span's name and edge are in the kernel's symbol, which the profiler
// records as the kernel's name:
//
//   void msda_span<encoder, begin>()
//
// and utils.profile.Trace (and the benchmark's perfbench/spans.py) pair a
// begin with the next end of its name and read the device work between
// them.  A marker is one thread of one block that does nothing: a graph
// node of about a microsecond.
//
// The names, in the order of their index (utils/profile.py DEVICE_SPANS):
// encoder, decoder, postprocess, loss, backward, optimizer, proposals,
// proposal_loss, dn_queries, dn_loss (proposals and dn_queries nested in
// decoder, proposal_loss and dn_loss in loss).
//
// Interface: plain C entry points, loaded with ctypes by utils/profile.py.
// msda_span_launch(span, edge, stream) launches one marker on the given
// stream (edge 0 begins, 1 ends) and returns cudaGetLastError();
// msda_span_prepare() loads every marker's function into the current
// device's context (cudaFuncGetAttributes), so that no marker is loaded
// lazily inside a capture.  Neither synchronises or allocates.
// msda_span_count() and msda_span_name(span) give the table's spans in
// order, each name the one in its markers' symbol, so that the loader can
// refuse a table whose order is not DEVICE_SPANS'.

#include <cuda_runtime.h>

struct encoder {};
struct decoder {};
struct postprocess {};
struct loss {};
struct backward {};
struct optimizer {};
struct proposals {};
struct proposal_loss {};
struct dn_queries {};
struct dn_loss {};

struct begin {};
struct end {};

template <class Name, class Edge>
__global__ void msda_span() {}

namespace {

struct Span {
  void (*edges[2])();  // begin, end
  const char* name;
};

// One row a span, in DEVICE_SPANS order; a row's name is spelt from the
// same token as its markers' template argument.
#define MSDA_SPAN(Name) {{msda_span<Name, begin>, msda_span<Name, end>}, #Name}
const Span kMarkers[] = {
    MSDA_SPAN(encoder),   MSDA_SPAN(decoder),       MSDA_SPAN(postprocess),
    MSDA_SPAN(loss),      MSDA_SPAN(backward),      MSDA_SPAN(optimizer),
    MSDA_SPAN(proposals), MSDA_SPAN(proposal_loss), MSDA_SPAN(dn_queries),
    MSDA_SPAN(dn_loss),
};
#undef MSDA_SPAN

constexpr int kSpans = sizeof(kMarkers) / sizeof(kMarkers[0]);

}  // namespace

extern "C" {

// Launch the marker of `span` (an index into DEVICE_SPANS) and `edge`
// (0 begin, 1 end) on `stream`.  Returns a cudaError_t.
int msda_span_launch(int span, int edge, void* stream) {
  if (span < 0 || span >= kSpans || edge < 0 || edge > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(kMarkers[span].edges[edge]), dim3(1),
      dim3(1), nullptr, 0, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Load every marker into the current device's context.  Returns a
// cudaError_t.
int msda_span_prepare() {
  cudaFuncAttributes attr;
  for (int s = 0; s < kSpans; ++s) {
    for (int e = 0; e < 2; ++e) {
      cudaError_t err = cudaFuncGetAttributes(
          &attr, reinterpret_cast<const void*>(kMarkers[s].edges[e]));
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaSuccess;
}

// The number of spans in the table.
int msda_span_count() { return kSpans; }

// The name of span `span` (an index into the table), or null.
const char* msda_span_name(int span) {
  return span < 0 || span >= kSpans ? nullptr : kMarkers[span].name;
}

}  // extern "C"
