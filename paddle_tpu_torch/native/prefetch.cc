// Multi-file prefetching recordio reader (native component of the PyTorch
// port; counterpart of paddle_tpu/native/prefetch.cc).
//
// Upstream's open_files reader stack (paddle/fluid/operators/reader/
// open_files_op.cc): N C++ worker threads scan recordio shards (PTR1,
// recordio.cc) and stage records into a bounded buffer, so the Python
// train loop never blocks on file IO or decompression.
//
// C API (loaded with ctypes):
//   pt_prefetch_create(paths, n_paths, n_threads, capacity)
//   pt_prefetch_next(p, &out, timeout_s)
//       -> len | -1 end | -2 timeout | -3 shard error (unopenable/corrupt)
//   pt_prefetch_destroy(p)

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// recordio.cc scanner entry points (same shared library).
extern "C" {
void* pt_recordio_scanner_open(const char* path);
long pt_recordio_next(void* sp, char** out);
void pt_recordio_scanner_close(void* sp);
void pt_free(char* p);
}

namespace {

struct Prefetcher {
  std::vector<std::string> paths;
  size_t capacity;
  std::deque<std::string> buf;
  std::mutex mu;
  std::condition_variable not_empty, not_full;
  std::vector<std::thread> workers;
  size_t n_workers = 0;  // fixed BEFORE any thread starts: workers.size()
                         // races with spawning and must not be the stride
  int live_workers = 0;
  bool stop = false;
  bool error = false;  // an unopenable or corrupt shard must surface, not
                       // silently truncate the dataset

  void worker(size_t start) {
    // files partitioned round-robin across threads
    for (size_t i = start; i < paths.size(); i += n_workers) {
      void* sc = pt_recordio_scanner_open(paths[i].c_str());
      if (sc == nullptr) {
        std::lock_guard<std::mutex> lk(mu);
        error = true;
        continue;
      }
      for (;;) {
        char* rec = nullptr;
        long n = pt_recordio_next(sc, &rec);
        if (n == -2) {  // corrupt chunk
          std::lock_guard<std::mutex> lk(mu);
          error = true;
          break;
        }
        if (n < 0) break;
        std::unique_lock<std::mutex> lk(mu);
        not_full.wait(lk, [&] { return buf.size() < capacity || stop; });
        if (stop) {
          pt_free(rec);
          pt_recordio_scanner_close(sc);
          goto done;
        }
        buf.emplace_back(rec, rec + n);
        pt_free(rec);
        not_empty.notify_one();
      }
      pt_recordio_scanner_close(sc);
    }
  done:
    std::lock_guard<std::mutex> lk(mu);
    if (--live_workers == 0) not_empty.notify_all();
  }
};

}  // namespace

extern "C" {

void* pt_prefetch_create(const char** paths, int n_paths, int n_threads,
                         long capacity) {
  auto* p = new Prefetcher();
  for (int i = 0; i < n_paths; ++i) p->paths.emplace_back(paths[i]);
  p->capacity = capacity > 0 ? static_cast<size_t>(capacity) : 256;
  int n = n_threads > 0 ? n_threads : 1;
  if (n > n_paths && n_paths > 0) n = n_paths;
  p->live_workers = n;
  p->n_workers = static_cast<size_t>(n);
  p->workers.reserve(n);
  for (int t = 0; t < n; ++t)
    p->workers.emplace_back([p, t] { p->worker(static_cast<size_t>(t)); });
  return p;
}

long pt_prefetch_next(void* pp, char** out, double timeout_s) {
  auto* p = static_cast<Prefetcher*>(pp);
  std::unique_lock<std::mutex> lk(p->mu);
  auto ready = [&] { return !p->buf.empty() || p->live_workers == 0; };
  if (timeout_s < 0) {
    p->not_empty.wait(lk, ready);
  } else if (!p->not_empty.wait_for(
                 lk, std::chrono::duration<double>(timeout_s), ready)) {
    return -2;  // timeout
  }
  if (p->buf.empty()) return p->error ? -3 : -1;  // drained (or failed)
  std::string rec = std::move(p->buf.front());
  p->buf.pop_front();
  p->not_full.notify_one();
  lk.unlock();
  *out = static_cast<char*>(malloc(rec.size()));
  memcpy(*out, rec.data(), rec.size());
  return static_cast<long>(rec.size());
}

void pt_prefetch_destroy(void* pp) {
  auto* p = static_cast<Prefetcher*>(pp);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->not_full.notify_all();
  p->not_empty.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
