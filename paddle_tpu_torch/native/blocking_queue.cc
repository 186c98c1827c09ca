// Bounded blocking byte-buffer queue (native component of the PyTorch
// port; counterpart of paddle_tpu/native/blocking_queue.cc).
//
// Upstream's operators/reader/lod_tensor_blocking_queue.h: the host-side
// hand-off between a reader's producer thread and the Executor's read op
// (py_reader / double_buffer).  Payloads are opaque byte buffers (the
// Python side packs tensor batches), closing wakes all waiters, and pops
// drain the remaining items after close (upstream's kill/close semantics).

#include <chrono>
#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>

namespace {

struct Queue {
  std::mutex mu;
  std::condition_variable not_full, not_empty;
  std::deque<std::string> items;
  size_t capacity;
  bool closed = false;

  explicit Queue(size_t cap) : capacity(cap ? cap : 1) {}
};

}  // namespace

extern "C" {

void* pt_queue_create(long capacity) {
  return new Queue(static_cast<size_t>(capacity));
}

// 0 ok; -1 closed; -2 timeout.  timeout<0 => wait forever.
int pt_queue_push(void* qp, const char* data, long len, double timeout_s) {
  auto* q = static_cast<Queue*>(qp);
  std::unique_lock<std::mutex> lk(q->mu);
  auto ready = [q] { return q->closed || q->items.size() < q->capacity; };
  if (timeout_s < 0) {
    q->not_full.wait(lk, ready);
  } else if (!q->not_full.wait_for(
                 lk, std::chrono::duration<double>(timeout_s), ready)) {
    return -2;
  }
  if (q->closed) return -1;
  q->items.emplace_back(data, len);
  q->not_empty.notify_one();
  return 0;
}

// >=0: length, *out malloc'd; -1 closed-and-drained; -2 timeout.
long pt_queue_pop(void* qp, char** out, double timeout_s) {
  auto* q = static_cast<Queue*>(qp);
  std::unique_lock<std::mutex> lk(q->mu);
  auto ready = [q] { return q->closed || !q->items.empty(); };
  if (timeout_s < 0) {
    q->not_empty.wait(lk, ready);
  } else if (!q->not_empty.wait_for(
                 lk, std::chrono::duration<double>(timeout_s), ready)) {
    return -2;
  }
  if (q->items.empty()) return -1;  // closed and drained
  std::string item = std::move(q->items.front());
  q->items.pop_front();
  q->not_full.notify_one();
  lk.unlock();
  *out = static_cast<char*>(malloc(item.size() ? item.size() : 1));
  memcpy(*out, item.data(), item.size());
  return static_cast<long>(item.size());
}

void pt_queue_close(void* qp) {
  auto* q = static_cast<Queue*>(qp);
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->not_full.notify_all();
  q->not_empty.notify_all();
}

int pt_queue_is_closed(void* qp) {
  auto* q = static_cast<Queue*>(qp);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->closed ? 1 : 0;
}

long pt_queue_size(void* qp) {
  auto* q = static_cast<Queue*>(qp);
  std::lock_guard<std::mutex> lk(q->mu);
  return static_cast<long>(q->items.size());
}

void pt_queue_reopen(void* qp) {
  auto* q = static_cast<Queue*>(qp);
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = false;
  q->items.clear();
}

void pt_queue_destroy(void* qp) { delete static_cast<Queue*>(qp); }

}  // extern "C"
