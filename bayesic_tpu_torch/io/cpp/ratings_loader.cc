// Native loader for rating-triple datasets: mmap'd columnar files, host
// shard reads, and a double-buffered threaded minibatch sampler.
//
// The same source and file format as bayesic_tpu/io/cpp/ratings_loader.cc,
// which the JAX package writes and reads.
//
// Format (little-endian, columnar):
//   magic  u64  0x42545052 31313030 ("BTPR0011")
//   n      u64  number of ratings
//   users  i32[n]
//   items  i32[n]
//   rating f32[n]
//
// API (extern "C", consumed via ctypes from bayesic_tpu_torch/io/ratings.py):
//   btpr_open(path) -> handle (mmap'd, read-only)
//   btpr_size(h) -> n
//   btpr_read_shard(h, start, count, users_out, items_out, ratings_out)
//   btpr_batch_start(h, batch, seed, nthreads) -> iterator
//   btpr_batch_next(it, users_out, items_out, ratings_out) -> batch or 0
//       (uniform with-replacement sampling, matching the plate subsampler;
//        the next batch is gathered by worker threads while the caller
//        consumes the current one — double buffered)
//   btpr_batch_close(it) / btpr_close(h)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <atomic>
#include <condition_variable>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x4254505230303131ULL;  // "BTPR0011"

struct Dataset {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t bytes = 0;
  uint64_t n = 0;
  const int32_t* users = nullptr;
  const int32_t* items = nullptr;
  const float* ratings = nullptr;
};

struct BatchIter {
  const Dataset* ds = nullptr;
  uint64_t batch = 0;
  uint64_t rounds = 0;     // monotone counter mixed into the RNG stream
  uint64_t seed = 0;
  int nthreads = 1;

  // double buffer
  std::vector<int32_t> u[2];
  std::vector<int32_t> i[2];
  std::vector<float> r[2];
  int ready_slot = -1;     // slot holding a completed batch
  int fill_slot = 0;
  bool stop = false;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_ready, cv_consumed;

  void fill(int slot, uint64_t round) {
    const uint64_t n = ds->n;
    auto gather = [&](uint64_t lo, uint64_t hi, uint64_t stream) {
      // per-chunk deterministic RNG: seed + round + stream id
      std::mt19937_64 gen(seed * 0x9E3779B97F4A7C15ULL + round * 1315423911ULL
                          + stream);
      std::uniform_int_distribution<uint64_t> pick(0, n - 1);
      for (uint64_t k = lo; k < hi; ++k) {
        const uint64_t idx = pick(gen);
        u[slot][k] = ds->users[idx];
        i[slot][k] = ds->items[idx];
        r[slot][k] = ds->ratings[idx];
      }
    };
    if (nthreads <= 1) {
      gather(0, batch, 0);
      return;
    }
    std::vector<std::thread> ts;
    const uint64_t per = (batch + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      const uint64_t lo = t * per;
      const uint64_t hi = std::min<uint64_t>(batch, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(gather, lo, hi, (uint64_t)t);
    }
    for (auto& t : ts) t.join();
  }

  void run() {
    uint64_t round = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_consumed.wait(lk, [&] { return stop || ready_slot == -1; });
        if (stop) return;
      }
      fill(fill_slot, round++);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready_slot = fill_slot;
        fill_slot ^= 1;
      }
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* btpr_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* ds = new Dataset;
  ds->fd = fd;
  ds->base = static_cast<const uint8_t*>(base);
  ds->bytes = st.st_size;
  uint64_t magic;
  memcpy(&magic, ds->base, 8);
  memcpy(&ds->n, ds->base + 8, 8);
  // Overflow-safe bounds check: validate n against the file size BEFORE
  // computing byte offsets (16 + n*12 can wrap size_t for a corrupt header).
  if (magic != kMagic || ds->n > (ds->bytes - 16) / 12) {
    munmap(base, st.st_size);
    ::close(fd);
    delete ds;
    return nullptr;
  }
  ds->users = reinterpret_cast<const int32_t*>(ds->base + 16);
  ds->items = reinterpret_cast<const int32_t*>(ds->base + 16 + ds->n * 4);
  ds->ratings = reinterpret_cast<const float*>(ds->base + 16 + ds->n * 8);
  // advise the kernel we'll stream this
  madvise(base, st.st_size, MADV_WILLNEED);
  return ds;
}

uint64_t btpr_size(void* h) {
  return h ? static_cast<Dataset*>(h)->n : 0;
}

int btpr_read_shard(void* h, uint64_t start, uint64_t count,
                    int32_t* users_out, int32_t* items_out,
                    float* ratings_out) {
  auto* ds = static_cast<Dataset*>(h);
  if (!ds || start + count > ds->n) return -1;
  memcpy(users_out, ds->users + start, count * 4);
  memcpy(items_out, ds->items + start, count * 4);
  memcpy(ratings_out, ds->ratings + start, count * 4);
  return 0;
}

void* btpr_batch_start(void* h, uint64_t batch, uint64_t seed,
                       int nthreads) {
  auto* ds = static_cast<Dataset*>(h);
  if (!ds || batch == 0) return nullptr;
  auto* it = new BatchIter;
  it->ds = ds;
  it->batch = batch;
  it->seed = seed;
  it->nthreads = nthreads < 1 ? 1 : nthreads;
  for (int s = 0; s < 2; ++s) {
    it->u[s].resize(batch);
    it->i[s].resize(batch);
    it->r[s].resize(batch);
  }
  it->worker = std::thread([it] { it->run(); });
  return it;
}

uint64_t btpr_batch_next(void* hit, int32_t* users_out, int32_t* items_out,
                         float* ratings_out) {
  auto* it = static_cast<BatchIter*>(hit);
  if (!it) return 0;
  int slot;
  {
    std::unique_lock<std::mutex> lk(it->mu);
    // also wake on stop: btpr_batch_close sets stop and notifies
    // cv_ready, so a consumer blocked here returns 0 instead of
    // deadlocking (and then touching freed memory)
    it->cv_ready.wait(lk, [&] { return it->stop || it->ready_slot != -1; });
    if (it->stop) return 0;
    slot = it->ready_slot;
  }
  memcpy(users_out, it->u[slot].data(), it->batch * 4);
  memcpy(items_out, it->i[slot].data(), it->batch * 4);
  memcpy(ratings_out, it->r[slot].data(), it->batch * 4);
  {
    std::lock_guard<std::mutex> lk(it->mu);
    it->ready_slot = -1;
  }
  it->cv_consumed.notify_one();
  return it->batch;
}

void btpr_batch_close(void* hit) {
  auto* it = static_cast<BatchIter*>(hit);
  if (!it) return;
  {
    std::lock_guard<std::mutex> lk(it->mu);
    it->stop = true;
    it->ready_slot = -1;
  }
  it->cv_consumed.notify_all();
  it->cv_ready.notify_all();   // release any consumer blocked in batch_next
  if (it->worker.joinable()) it->worker.join();
  delete it;
}

void btpr_close(void* h) {
  auto* ds = static_cast<Dataset*>(h);
  if (!ds) return;
  munmap(const_cast<uint8_t*>(ds->base), ds->bytes);
  ::close(ds->fd);
  delete ds;
}

}  // extern "C"
