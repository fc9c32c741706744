// fitslam_tpu_torch native host runtime: the port's own copy of the
// reference's native/runtime.cc, built by g++ into build/native/ at first use
// (fitslam_tpu_torch/utils/cuda_build.py) and bound by
// fitslam_tpu_torch/runtime/native.py.
//
// The host-side pieces that must never stall the device pipeline:
//   - a lock-free SPSC ring buffer (the in-process DDS-topic analog),
//   - a threaded image-sequence reader with prefetch (PGM P5 sequences;
//     the camera-driver/rosbag-replay analog feeding the ORB frontend),
//   - a nanosecond event logger with CSV export (event_logger.cpp analog).
// Exposed as a C ABI for ctypes.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <mutex>
#include <string>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Clock
// ---------------------------------------------------------------------------

int64_t fit_now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------------------------
// Lock-free SPSC ring buffer of fixed-size slots
// ---------------------------------------------------------------------------

struct FitRing {
  std::vector<uint8_t> data;
  size_t slot_size = 0;
  size_t n_slots = 0;
  std::atomic<uint64_t> head{0};  // next write
  std::atomic<uint64_t> tail{0};  // next read
};

void* fit_ring_create(size_t slot_size, size_t n_slots) {
  auto* r = new FitRing();
  r->slot_size = slot_size;
  r->n_slots = n_slots;
  r->data.resize(slot_size * n_slots);
  return r;
}

void fit_ring_destroy(void* h) { delete static_cast<FitRing*>(h); }

size_t fit_ring_size(void* h) {
  auto* r = static_cast<FitRing*>(h);
  return static_cast<size_t>(r->head.load(std::memory_order_acquire) -
                             r->tail.load(std::memory_order_acquire));
}

// returns 1 on success, 0 if full
int fit_ring_push(void* h, const uint8_t* src, size_t len) {
  auto* r = static_cast<FitRing*>(h);
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->n_slots) return 0;
  size_t slot = static_cast<size_t>(head % r->n_slots);
  size_t n = std::min(len, r->slot_size);
  std::memcpy(&r->data[slot * r->slot_size], src, n);
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

// returns 1 on success, 0 if empty
int fit_ring_pop(void* h, uint8_t* dst, size_t len) {
  auto* r = static_cast<FitRing*>(h);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  if (head == tail) return 0;
  size_t slot = static_cast<size_t>(tail % r->n_slots);
  size_t n = std::min(len, r->slot_size);
  std::memcpy(dst, &r->data[slot * r->slot_size], n);
  r->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

// ---------------------------------------------------------------------------
// PGM (P5, 8-bit) sequence reader with prefetch thread
// ---------------------------------------------------------------------------

struct FitSeqReader {
  std::vector<std::string> files;
  size_t next_submit = 0;
  int width = 0, height = 0;
  FitRing* ring = nullptr;
  std::thread worker;
  std::atomic<bool> stop{false};
  std::atomic<int> error{0};
};

static bool read_pgm(const std::string& path, std::vector<uint8_t>& out,
                     int* w, int* h) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  char magic[3] = {0};
  if (std::fscanf(f, "%2s", magic) != 1 || std::strcmp(magic, "P5") != 0) {
    std::fclose(f);
    return false;
  }
  auto skip_ws_comments = [&]() {
    int c;
    while ((c = std::fgetc(f)) != EOF) {
      if (c == '#') {
        while ((c = std::fgetc(f)) != EOF && c != '\n') {}
      } else if (!isspace(c)) {
        std::ungetc(c, f);
        return;
      }
    }
  };
  int width, height, maxval;
  skip_ws_comments();
  if (std::fscanf(f, "%d", &width) != 1) { std::fclose(f); return false; }
  skip_ws_comments();
  if (std::fscanf(f, "%d", &height) != 1) { std::fclose(f); return false; }
  skip_ws_comments();
  if (std::fscanf(f, "%d", &maxval) != 1 || maxval > 255) { std::fclose(f); return false; }
  std::fgetc(f);  // single whitespace after header
  out.resize(static_cast<size_t>(width) * height);
  size_t got = std::fread(out.data(), 1, out.size(), f);
  std::fclose(f);
  if (got != out.size()) return false;
  *w = width;
  *h = height;
  return true;
}

void* fit_seqreader_open(const char* dir, size_t prefetch_slots) {
  auto* s = new FitSeqReader();
  DIR* d = opendir(dir);
  if (!d) { delete s; return nullptr; }
  struct dirent* e;
  while ((e = readdir(d)) != nullptr) {
    std::string name = e->d_name;
    if (name.size() > 4 && name.substr(name.size() - 4) == ".pgm")
      s->files.push_back(std::string(dir) + "/" + name);
  }
  closedir(d);
  std::sort(s->files.begin(), s->files.end());
  if (s->files.empty()) { delete s; return nullptr; }
  // probe first file for dimensions
  std::vector<uint8_t> probe;
  if (!read_pgm(s->files[0], probe, &s->width, &s->height)) {
    delete s;
    return nullptr;
  }
  size_t slot = static_cast<size_t>(s->width) * s->height;
  s->ring = static_cast<FitRing*>(fit_ring_create(slot, prefetch_slots));
  s->worker = std::thread([s, slot]() {
    std::vector<uint8_t> buf;
    for (size_t i = 0; i < s->files.size() && !s->stop.load(); ++i) {
      int w, h;
      if (!read_pgm(s->files[i], buf, &w, &h) ||
          w != s->width || h != s->height) {
        s->error.store(1);
        return;
      }
      while (!fit_ring_push(s->ring, buf.data(), slot)) {
        if (s->stop.load()) return;
        std::this_thread::sleep_for(std::chrono::microseconds(100));
      }
    }
  });
  return s;
}

int fit_seqreader_width(void* h) { return static_cast<FitSeqReader*>(h)->width; }
int fit_seqreader_height(void* h) { return static_cast<FitSeqReader*>(h)->height; }
int64_t fit_seqreader_count(void* h) {
  return static_cast<int64_t>(static_cast<FitSeqReader*>(h)->files.size());
}

// blocking next frame; returns 1 ok, 0 sequence exhausted, -1 read error
int fit_seqreader_next(void* h, uint8_t* dst, size_t len, int64_t consumed) {
  auto* s = static_cast<FitSeqReader*>(h);
  size_t slot = static_cast<size_t>(s->width) * s->height;
  if (static_cast<size_t>(consumed) >= s->files.size()) return 0;
  while (true) {
    if (fit_ring_pop(s->ring, dst, std::min(len, slot))) return 1;
    if (s->error.load()) return -1;
    std::this_thread::sleep_for(std::chrono::microseconds(100));
  }
}

void fit_seqreader_close(void* h) {
  auto* s = static_cast<FitSeqReader*>(h);
  s->stop.store(true);
  if (s->worker.joinable()) s->worker.join();
  fit_ring_destroy(s->ring);
  delete s;
}

// ---------------------------------------------------------------------------
// Event logger (event_logger.cpp analog): named begin/end, CSV export
// ---------------------------------------------------------------------------

struct FitEvent {
  char name[48];
  int64_t t_begin_ns;
  int64_t t_end_ns;
};

struct FitEventLog {
  std::vector<FitEvent> events;
  std::mutex mu;
};

void* fit_eventlog_create() { return new FitEventLog(); }
void fit_eventlog_destroy(void* h) { delete static_cast<FitEventLog*>(h); }

int64_t fit_eventlog_begin(void* h, const char* name) {
  auto* l = static_cast<FitEventLog*>(h);
  std::lock_guard<std::mutex> g(l->mu);
  FitEvent e{};
  std::strncpy(e.name, name, sizeof(e.name) - 1);
  e.t_begin_ns = fit_now_ns();
  e.t_end_ns = -1;
  l->events.push_back(e);
  return static_cast<int64_t>(l->events.size()) - 1;
}

void fit_eventlog_end(void* h, int64_t idx) {
  auto* l = static_cast<FitEventLog*>(h);
  std::lock_guard<std::mutex> g(l->mu);
  if (idx >= 0 && idx < static_cast<int64_t>(l->events.size()))
    l->events[idx].t_end_ns = fit_now_ns();
}

int64_t fit_eventlog_count(void* h) {
  auto* l = static_cast<FitEventLog*>(h);
  std::lock_guard<std::mutex> g(l->mu);
  return static_cast<int64_t>(l->events.size());
}

// writes "name,begin_ns,end_ns\n" rows; returns rows written
int64_t fit_eventlog_export_csv(void* h, const char* path) {
  auto* l = static_cast<FitEventLog*>(h);
  std::lock_guard<std::mutex> g(l->mu);
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  std::fprintf(f, "name,begin_ns,end_ns\n");
  for (const auto& e : l->events)
    std::fprintf(f, "%s,%lld,%lld\n", e.name,
                 static_cast<long long>(e.t_begin_ns),
                 static_cast<long long>(e.t_end_ns));
  std::fclose(f);
  return static_cast<int64_t>(l->events.size());
}

}  // extern "C"
