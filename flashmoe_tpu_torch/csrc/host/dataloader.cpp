// flashmoe_tpu_torch's native data loader: binary token shards with
// background prefetch (the port's own copy of the JAX package's loader,
// the same C API and window order).
//
// Format: a flat little-endian int32 token stream.  The loader cuts it
// into [batch, seq_len + 1] windows (next-token targets share the window),
// optionally shuffling window order per epoch with an xorshift PRNG, and a
// background thread keeps a small ring of batches decoded ahead of the
// consumer.
//
// Built with g++ at first use by flashmoe_tpu_torch/runtime/_native.py
// and bound with ctypes by flashmoe_tpu_torch/runtime/data.py, whose NumPy
// arm has the same semantics.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct XorShift {
  uint64_t s;
  explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ull) {}
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
};

struct Loader {
  std::vector<int32_t> tokens;
  int64_t seq_len = 0;
  int64_t batch = 0;
  uint64_t seed = 0;
  bool shuffle = false;

  std::vector<int64_t> order;   // window start indices, epoch order
  int64_t cursor = 0;           // next window in `order`
  int64_t epoch = 0;

  std::deque<std::vector<int32_t>> queue;
  size_t depth = 4;
  std::mutex mu;
  std::condition_variable cv_pop, cv_push;
  std::thread worker;
  bool stop = false;

  int64_t window() const { return seq_len + 1; }
  int64_t num_windows() const {
    return (int64_t)tokens.size() / window();
  }

  void reshuffle() {
    int64_t n = num_windows();
    order.resize(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i * window();
    if (shuffle) {
      XorShift rng(seed + 0x51ed270b * (uint64_t)(epoch + 1));
      for (int64_t i = n - 1; i > 0; --i) {
        int64_t j = (int64_t)(rng.next() % (uint64_t)(i + 1));
        std::swap(order[i], order[j]);
      }
    }
  }

  void fill_batch(std::vector<int32_t>& out) {
    out.resize(batch * window());
    for (int64_t b = 0; b < batch; ++b) {
      if (cursor >= (int64_t)order.size()) {
        ++epoch;
        cursor = 0;
        reshuffle();
      }
      std::memcpy(out.data() + b * window(),
                  tokens.data() + order[cursor], window() * sizeof(int32_t));
      ++cursor;
    }
  }

  void run() {
    for (;;) {
      std::vector<int32_t> buf;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return stop || queue.size() < depth; });
        if (stop) return;
      }
      fill_batch(buf);
      {
        std::unique_lock<std::mutex> lk(mu);
        queue.push_back(std::move(buf));
      }
      cv_pop.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* flashmoe_loader_open(const char* path, int64_t seq_len, int64_t batch,
                           uint64_t seed, int shuffle) {
  if (seq_len <= 0 || batch <= 0) return nullptr;
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  auto* ld = new Loader();
  ld->tokens.resize(bytes / sizeof(int32_t));
  size_t got = std::fread(ld->tokens.data(), sizeof(int32_t),
                          ld->tokens.size(), f);
  std::fclose(f);
  ld->tokens.resize(got);
  ld->seq_len = seq_len;
  ld->batch = batch;
  ld->seed = seed;
  ld->shuffle = shuffle != 0;
  if (ld->num_windows() < 1) {
    delete ld;
    return nullptr;
  }
  ld->reshuffle();
  ld->worker = std::thread([ld] { ld->run(); });
  return ld;
}

// Copies one [batch, seq_len+1] int32 batch into `out`. Returns 0 on
// success.
int flashmoe_loader_next(void* handle, int32_t* out) {
  auto* ld = static_cast<Loader*>(handle);
  if (!ld) return 1;
  std::vector<int32_t> buf;
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    ld->cv_pop.wait(lk, [&] { return ld->stop || !ld->queue.empty(); });
    if (ld->queue.empty()) return 1;
    buf = std::move(ld->queue.front());
    ld->queue.pop_front();
  }
  ld->cv_push.notify_one();
  std::memcpy(out, buf.data(), buf.size() * sizeof(int32_t));
  return 0;
}

int64_t flashmoe_loader_num_windows(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  return ld ? ld->num_windows() : -1;
}

void flashmoe_loader_close(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  if (!ld) return;
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    ld->stop = true;
  }
  ld->cv_push.notify_all();
  ld->cv_pop.notify_all();
  if (ld->worker.joinable()) ld->worker.join();
  delete ld;
}

}  // extern "C"
