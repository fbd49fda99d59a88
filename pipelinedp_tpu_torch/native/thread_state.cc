// PyTorch's thread-local state (grad mode, dispatch keys, the profiler's
// state and its operator callbacks) as an opaque handle, so that a thread
// PyTorch did not start can run under the state of the thread that
// started it, as PyTorch's own pool threads do (``at::launch`` wraps its
// tasks in ``at::ThreadLocalStateGuard``). Loaded by ``thread_state.py``.

#include <ATen/ThreadLocalState.h>

extern "C" {

// The calling thread's state, copied.
void* pdp_tls_capture() { return new at::ThreadLocalState(); }

// Makes ``state`` the calling thread's state.
void pdp_tls_set(const void* state) {
  at::ThreadLocalState::setThreadLocalState(
      *static_cast<const at::ThreadLocalState*>(state));
}

void pdp_tls_free(void* state) {
  delete static_cast<at::ThreadLocalState*>(state);
}

}  // extern "C"
