// Phase marks of the train step: an empty kernel per phase.
//
// Replaces no TPU kernel: the JAX package has no trace annotations. A CUDA
// graph replay runs no host code, so a host span cannot say where a phase
// of a replayed step begins on the device. With the port's tracing on
// (utils/logging.py::set_tracing), `mark` launches the kernel of the phase
// that begins, one thread, on the current stream; captured in a graph it
// becomes a node of the graph and runs at every replay. The kernel reads
// and writes nothing. Its name carries the phase, e.g.
// `void d3g_mark<d3g_phase::render>()`, so a profiler trace alone tells the
// phases apart. Bound: the launch itself, ~1-2 us a mark on the device.
//
// The phase index of d3g_mark_launch follows utils/logging.py::PHASES.
//
// View marks, a second empty kernel `d3g_view_mark<d3g_view::<view>>`, say
// where a step's work on one group of views begins inside a phase (the ego
// + static trainer: where its static views' own renders begin, and where
// the backward reaches the ego view's render). Their name holds no
// `d3g_mark<d3g_phase::`, so a reader of the phase marks does not see them.
// The view index of d3g_view_mark_launch follows utils/logging.py::VIEWS.

#include <cuda_runtime.h>

namespace d3g_phase {
struct render {};
struct image_loss {};
struct physics {};
struct physics_bwd {};
struct image_loss_bwd {};
struct render_bwd {};
struct update {};
}  // namespace d3g_phase

namespace d3g_view {
struct static_rig {};
struct ego {};
}  // namespace d3g_view

template <typename Phase>
__global__ void d3g_mark() {}

template <typename View>
__global__ void d3g_view_mark() {}

template <typename Phase>
static void launch(cudaStream_t stream) {
  d3g_mark<Phase><<<1, 1, 0, stream>>>();
}

extern "C" int d3g_mark_launch(int phase, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0: launch<d3g_phase::render>(s); break;
    case 1: launch<d3g_phase::image_loss>(s); break;
    case 2: launch<d3g_phase::physics>(s); break;
    case 3: launch<d3g_phase::physics_bwd>(s); break;
    case 4: launch<d3g_phase::image_loss_bwd>(s); break;
    case 5: launch<d3g_phase::render_bwd>(s); break;
    case 6: launch<d3g_phase::update>(s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int d3g_view_mark_launch(int view, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (view) {
    case 0: d3g_view_mark<d3g_view::static_rig><<<1, 1, 0, s>>>(); break;
    case 1: d3g_view_mark<d3g_view::ego><<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
