// Native batch-file loader engine (C++17, no deps beyond the STL).
//
// A copy of theanompi_tpu/native/loader.cc (no framework in it), bound
// by theanompi_tpu_torch/native/__init__.py.
//
// The reference's async input pipeline is a spawned MPI loader process
// per worker (theanompi/models/data/proc_load_mpi.py: recv filename ->
// hickle.load -> random crop + horizontal flip - mean -> shared GPU
// buffer handshake).  The TPU rebuild replaces hickle/HDF5 (C library
// libhdf5) and the MPI-spawned process with this in-tree C++ engine:
//
//   * .tmb batch files — raw, mmap-friendly:
//       [0:4)   magic "TMB1"
//       [4:20)  int32 n, h, w, c   (little-endian)
//       [20:20+4n)            int32 labels
//       [20+4n: ... )         uint8 pixels, NHWC
//   * a pool of worker threads, each: pread the file, random-crop +
//     hflip + mean-subtract into float32 NHWC, deterministic per
//     (seed, epoch, position) whatever thread runs it;
//   * a bounded in-order delivery ring (depth slots of backpressure),
//     consumer side blocks in tm_next until the next sequence number
//     is ready.
//
// Exposed as a tiny C ABI consumed via ctypes (theanompi_tpu_torch/
// native/__init__.py) — no pybind11 dependency.

#include <fcntl.h>
#include <pthread.h>
#include <sched.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// CPU affinity for loader workers (SURVEY §2.1 "CPU binding / NUMA"
// row; reference: per-rank core binding in the MPI launcher).
// TM_LOADER_AFFINITY = "a,b,c-d,..." pins worker i to cpu list[i %
// len]; "auto" spreads workers over all online CPUs.  Returns the
// cpu list (empty = no pinning requested / parse failure).
std::vector<int> affinity_cpus() {
  const char* env = std::getenv("TM_LOADER_AFFINITY");
  std::vector<int> cpus;
  if (!env || !*env) return cpus;
  if (std::strcmp(env, "auto") == 0) {
    long n = sysconf(_SC_NPROCESSORS_ONLN);
    for (long i = 0; i < n; ++i) cpus.push_back((int)i);
    return cpus;
  }
  const char* p = env;
  while (*p) {
    char* end;
    long a = std::strtol(p, &end, 10);
    if (end == p) return {};  // malformed: pin nothing
    long b = a;
    p = end;
    if (*p == '-') {
      b = std::strtol(p + 1, &end, 10);
      if (end == p + 1) return {};
      p = end;
    }
    for (long v = a; v <= b; ++v) cpus.push_back((int)v);
    if (*p == ',') ++p;
  }
  return cpus;
}

bool pin_thread(std::thread& t, int cpu) {
  cpu_set_t set;
  CPU_ZERO(&set);
  CPU_SET(cpu, &set);
  return pthread_setaffinity_np(t.native_handle(), sizeof(set), &set) == 0;
}

// Shared augmentation hash (public splitmix64 mixer): the Python
// producer (models/data/aug_rng.py) implements the identical
// function, so crops/flips agree bit-for-bit across producers.
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

struct Header {
  int32_t n, h, w, c;
};

struct Batch {
  // fp32 wire: augmented pixels land in xf; u8 wire (raw_u8 mode,
  // mean-subtract on device): crops land in xu
  std::vector<float> xf;
  std::vector<uint8_t> xu;
  std::vector<int32_t> y;
};

bool read_header(const std::string& path, Header* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  char magic[4];
  bool ok = std::fread(magic, 1, 4, f) == 4 &&
            std::memcmp(magic, "TMB1", 4) == 0 &&
            std::fread(out, sizeof(int32_t), 4, f) == 4;
  std::fclose(f);
  return ok && out->n > 0 && out->h > 0 && out->w > 0 && out->c > 0;
}

// Whole-file pread into caller buffers (labels + pixels).  POSIX read
// avoids stdio's internal buffer copy on the ~25 MB pixel block.
// pread may legally return short (signals, network filesystems), so
// BOTH blocks loop until complete.
bool pread_all(int fd, uint8_t* buf, size_t n, size_t off) {
  size_t done = 0;
  while (done < n) {
    ssize_t r = ::pread(fd, buf + done, n - done, (off_t)(off + done));
    if (r <= 0) return false;
    done += (size_t)r;
  }
  return true;
}

bool read_body(const std::string& path, int32_t* labels, size_t n_labels,
               uint8_t* px, size_t n_px) {
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) return false;
  const size_t label_bytes = n_labels * sizeof(int32_t);
  bool ok =
      pread_all(fd, reinterpret_cast<uint8_t*>(labels), label_bytes, 20) &&
      pread_all(fd, px, n_px, 20 + label_bytes);
  ::close(fd);
  return ok;
}

class Loader {
 public:
  Loader(std::vector<std::string> files, Header hdr, int crop, int depth,
         int n_threads, uint64_t seed, std::vector<float> mean,
         bool raw_u8)
      : files_(std::move(files)),
        hdr_(hdr),
        crop_(crop),
        depth_(depth < 1 ? 1 : depth),
        seed_(seed),
        mean_(std::move(mean)),
        raw_u8_(raw_u8) {
    order_.resize(files_.size());
    for (size_t i = 0; i < order_.size(); ++i) order_[i] = (int)i;
    const std::vector<int> cpus = affinity_cpus();
    for (int t = 0; t < n_threads; ++t) {
      workers_.emplace_back([this] { worker(); });
      if (!cpus.empty() &&
          pin_thread(workers_.back(), cpus[t % cpus.size()]))
        ++pinned_;
    }
  }

  int pinned() const { return pinned_; }

  ~Loader() {
    {
      std::lock_guard<std::mutex> l(m_);
      stop_ = true;
    }
    cv_work_.notify_all();
    cv_ready_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void set_epoch(int epoch, const int32_t* perm, int n) {
    std::lock_guard<std::mutex> l(m_);
    if (perm && n > 0) order_.assign(perm, perm + n);
    epoch_ = epoch;
    ++generation_;
    next_claim_ = 0;
    next_deliver_ = 0;
    ready_.clear();
    failed_ = false;  // a past transient error doesn't poison new epochs
    cv_work_.notify_all();
  }

  // Blocks until the next in-order batch is ready; copies it out.
  // Returns 0 on success, 1 past end-of-epoch, 2 on file error.
  // Exactly one of x_out (fp32 wire) / xu_out (u8 wire) is non-null,
  // matching the mode the loader was opened with.
  int next(float* x_out, uint8_t* xu_out, int32_t* y_out) {
    std::unique_lock<std::mutex> l(m_);
    if (next_deliver_ >= (long)order_.size()) return 1;
    long want = next_deliver_;
    cv_ready_.wait(l, [&] {
      return stop_ || failed_ || ready_.count(want) != 0;
    });
    if (stop_) return 1;
    if (failed_ && ready_.count(want) == 0) return 2;
    Batch b = std::move(ready_[want]);
    ready_.erase(want);
    ++next_deliver_;
    cv_work_.notify_all();
    l.unlock();
    if (x_out)
      std::memcpy(x_out, b.xf.data(), b.xf.size() * sizeof(float));
    if (xu_out) std::memcpy(xu_out, b.xu.data(), b.xu.size());
    std::memcpy(y_out, b.y.data(), b.y.size() * sizeof(int32_t));
    // recycle the buffers: a fresh 77 MB vector per batch costs an
    // alloc + first-touch page-zeroing each time (measured as a large
    // share of the single-core budget); the freelist caps live
    // buffers at ~depth and makes steady-state allocation-free
    {
      std::lock_guard<std::mutex> fl(m_);
      if ((int)free_.size() < depth_ + 2) free_.push_back(std::move(b));
    }
    return 0;
  }

 private:
  void worker() {
    for (;;) {
      long seq;
      long gen;
      int file_idx, epoch;
      {
        std::unique_lock<std::mutex> l(m_);
        cv_work_.wait(l, [&] {
          return stop_ || (next_claim_ < (long)order_.size() &&
                           next_claim_ - next_deliver_ < depth_);
        });
        if (stop_) return;
        gen = generation_;
        seq = next_claim_++;
        // copy under the lock: set_epoch may reassign order_/epoch_
        file_idx = order_[seq];
        epoch = epoch_;
      }
      Batch b;
      {
        std::lock_guard<std::mutex> l(m_);
        if (!free_.empty()) {
          b = std::move(free_.back());
          free_.pop_back();
        }
      }
      bool ok = process(file_idx, epoch, seq, &b);
      {
        std::lock_guard<std::mutex> l(m_);
        if (gen != generation_) continue;  // stale epoch: drop
        if (!ok) {
          failed_ = true;
        } else {
          ready_[seq] = std::move(b);
        }
      }
      cv_ready_.notify_all();
    }
  }

  bool process(int file_idx, int epoch, long seq, Batch* out) {
    const Header& h = hdr_;
    const size_t n_px = (size_t)h.n * h.h * h.w * h.c;
    // per-worker scratch for the raw file: reused across batches, so
    // steady state does no allocation and no page-zeroing (a fresh
    // value-initialized vector memsets its ~25 MB before the read
    // overwrites it)
    static thread_local std::vector<uint8_t> px;
    if (px.size() < n_px) px.resize(n_px);
    out->y.resize(h.n);
    if (!read_body(files_[file_idx], out->y.data(), (size_t)h.n,
                   px.data(), n_px))
      return false;

    // Augmentation draws are a PURE FUNCTION of (seed, epoch, seq, k)
    // via splitmix64 — bit-identical to the Python producer
    // (models/data/aug_rng.py), so the same logical batch gets the
    // same crops/flips whichever path serves it.
    const int cr = crop_;
    const size_t out_n = (size_t)h.n * cr * cr * h.c;
    if (raw_u8_) {
      if (out->xu.size() != out_n) out->xu.resize(out_n);
    } else {
      if (out->xf.size() != out_n) out->xf.resize(out_n);
    }
    const int c = h.c;
    const int rowlen = cr * c;
    // mean_ is always a full [cr, cr, c] image (Python broadcasts
    // per-channel / scalar means before the call)
    for (int k = 0; k < h.n; ++k) {
      const uint64_t base =
          seed_ ^ (0x9e3779b97f4a7c15ULL * (uint64_t)epoch) ^
          (0xbf58476d1ce4e5b9ULL * ((uint64_t)seq + 1)) ^
          (0x94d049bb133111ebULL * ((uint64_t)k + 1));
      const int i0 = (int)(splitmix64(base ^ 1) % (uint64_t)(h.h - cr + 1));
      const int j0 = (int)(splitmix64(base ^ 2) % (uint64_t)(h.w - cr + 1));
      const bool flip = (splitmix64(base ^ 3) & 1) != 0;
      const uint8_t* src = px.data() + (size_t)k * h.h * h.w * h.c;
      for (int i = 0; i < cr; ++i) {
        const uint8_t* row = src + ((size_t)(i0 + i) * h.w + j0) * c;
        if (raw_u8_) {
          uint8_t* drow = out->xu.data() + ((size_t)k * cr + i) * rowlen;
          if (!flip) {
            std::memcpy(drow, row, (size_t)rowlen);
          } else {
            for (int j = 0; j < cr; ++j) {
              const uint8_t* p = row + (size_t)(cr - 1 - j) * c;
              uint8_t* d = drow + (size_t)j * c;
              for (int ch = 0; ch < c; ++ch) d[ch] = p[ch];
            }
          }
          continue;
        }
        float* drow = out->xf.data() + ((size_t)k * cr + i) * rowlen;
        const float* mrow = mean_.data() + (size_t)i * rowlen;
        if (!flip) {
          // contiguous row: one u8->f32 convert-subtract sweep the
          // compiler vectorizes (the per-pixel pointer walk defeated
          // auto-vectorization at c=3)
          for (int t = 0; t < rowlen; ++t)
            drow[t] = (float)row[t] - mrow[t];
        } else {
          for (int j = 0; j < cr; ++j) {
            const uint8_t* p = row + (size_t)(cr - 1 - j) * c;
            float* d = drow + (size_t)j * c;
            const float* mp = mrow + (size_t)j * c;
            for (int ch = 0; ch < c; ++ch)
              d[ch] = (float)p[ch] - mp[ch];
          }
        }
      }
    }
    return true;
  }

  std::vector<std::string> files_;
  Header hdr_;
  int crop_, depth_;
  uint64_t seed_;
  std::vector<float> mean_;

  std::mutex m_;
  std::condition_variable cv_work_, cv_ready_;
  std::vector<std::thread> workers_;
  std::vector<int> order_;
  std::map<long, Batch> ready_;
  std::vector<Batch> free_;   // recycled output buffers (see next())
  long next_claim_ = 0, next_deliver_ = 0, generation_ = 0;
  int epoch_ = 0;
  int pinned_ = 0;
  bool stop_ = false, failed_ = false;
  bool raw_u8_ = false;
};

}  // namespace

extern "C" {

// Opens a loader over n_files .tmb paths (NUL-separated blob).  mean
// must be crop*crop*c floats (a full mean image; caller broadcasts).
// raw_u8 != 0 selects the uint8 wire (crop+flip only; mean-subtract
// happens on DEVICE — 4x fewer host bytes end to end).  Returns
// nullptr if any header is unreadable or inconsistent.
void* tm_loader_open(const char* paths_blob, int n_files, int crop,
                     int depth, int n_threads, uint64_t seed,
                     const float* mean, int mean_len, int raw_u8) {
  std::vector<std::string> files;
  const char* p = paths_blob;
  for (int i = 0; i < n_files; ++i) {
    files.emplace_back(p);
    p += files.back().size() + 1;
  }
  if (files.empty()) return nullptr;
  Header hdr;
  if (!read_header(files[0], &hdr)) return nullptr;
  for (size_t i = 1; i < files.size(); ++i) {
    Header h2;
    if (!read_header(files[i], &h2) || std::memcmp(&h2, &hdr, sizeof(hdr)))
      return nullptr;
  }
  if (crop <= 0 || crop > hdr.h || crop > hdr.w) return nullptr;
  if (mean_len != crop * crop * hdr.c) return nullptr;
  std::vector<float> m(mean, mean + mean_len);
  return new Loader(std::move(files), hdr, crop, depth,
                    n_threads < 1 ? 1 : n_threads, seed, std::move(m),
                    raw_u8 != 0);
}

void tm_loader_set_epoch(void* handle, int epoch, const int32_t* perm,
                         int n) {
  static_cast<Loader*>(handle)->set_epoch(epoch, perm, n);
}

int tm_loader_next(void* handle, float* x_out, int32_t* y_out) {
  return static_cast<Loader*>(handle)->next(x_out, nullptr, y_out);
}

// u8-wire variant (raw_u8 mode): x_out is uint8 [n, crop, crop, c].
int tm_loader_next_u8(void* handle, uint8_t* x_out, int32_t* y_out) {
  return static_cast<Loader*>(handle)->next(nullptr, x_out, y_out);
}

// Worker threads successfully pinned to a CPU (TM_LOADER_AFFINITY).
int tm_loader_pinned(void* handle) {
  return static_cast<Loader*>(handle)->pinned();
}

void tm_loader_close(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
