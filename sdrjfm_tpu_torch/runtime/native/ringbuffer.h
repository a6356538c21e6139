// Lock-free single-producer/single-consumer ring buffer.
//
// Role model: the reference's portaudio-derived SPSC ring
// (includes/various/ringbuffer.h — power-of-2 size, acquire/release
// ordering) which every device handler uses to hand samples to the DSP
// thread.  This is a fresh implementation on std::atomic with the same
// contract: one writer thread, one reader thread, no locks.
//
// Arrival log: after each put the producer notes how many elements the ring
// had received in all and when (steady_clock ns), in a log of the last
// kLog puts; the consumer asks when the element it read last arrived
// (`last_read_arrival_ns`).  On Linux steady_clock reads CLOCK_MONOTONIC,
// the clock of Python's time.monotonic_ns().
#pragma once

#include <atomic>
#include <chrono>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace sdrjfm {

template <typename T>
class SpscRing {
 public:
  explicit SpscRing(size_t size_pow2) : mask_(size_pow2 - 1),
                                        buf_(size_pow2) {
    // size must be a power of two
    if ((size_pow2 & (size_pow2 - 1)) != 0) {
      size_t s = 1;
      while (s < size_pow2) s <<= 1;
      buf_.resize(s);
      mask_ = s - 1;
    }
  }

  size_t capacity() const { return buf_.size(); }

  size_t readAvailable() const {
    return head_.load(std::memory_order_acquire) -
           tail_.load(std::memory_order_relaxed);
  }

  size_t writeSpace() const {
    return capacity() - (head_.load(std::memory_order_relaxed) -
                         tail_.load(std::memory_order_acquire));
  }

  // Returns number of elements actually written (may be < n when full).
  size_t put(const T* src, size_t n) {
    size_t head = head_.load(std::memory_order_relaxed);
    size_t space = capacity() - (head - tail_.load(std::memory_order_acquire));
    if (n > space) n = space;
    for (size_t i = 0; i < n; ++i) buf_[(head + i) & mask_] = src[i];
    if (n) {
      // logged before the elements are published, so a reader that sees
      // them sees their entry
      size_t k = log_n_.load(std::memory_order_relaxed);
      log_[k % kLog].end.store(head + n, std::memory_order_relaxed);
      log_[k % kLog].ns.store(steady_ns(), std::memory_order_relaxed);
      log_n_.store(k + 1, std::memory_order_release);
    }
    head_.store(head + n, std::memory_order_release);
    return n;
  }

  // Returns number of elements actually read (may be < n when empty).
  size_t get(T* dst, size_t n) {
    size_t tail = tail_.load(std::memory_order_relaxed);
    size_t avail = head_.load(std::memory_order_acquire) - tail;
    if (n > avail) n = avail;
    for (size_t i = 0; i < n; ++i) dst[i] = buf_[(tail + i) & mask_];
    tail_.store(tail + n, std::memory_order_release);
    return n;
  }

  void reset() {
    tail_.store(head_.load(std::memory_order_acquire),
                std::memory_order_release);
  }

  // Consumer side: when the put that made the last element read so far
  // readable published it (steady_clock ns); -1 before any read, or when
  // the log has moved past that put.
  int64_t last_read_arrival_ns() const {
    size_t pos = tail_.load(std::memory_order_relaxed);
    if (pos == 0) return -1;
    size_t n = log_n_.load(std::memory_order_acquire);
    size_t lo = n > kLog ? n - kLog : 0;
    int64_t ns = -1;
    size_t i = n;
    // newest first: the earliest put whose cumulative end reaches pos
    while (i > lo) {
      const Arrival& a = log_[(i - 1) % kLog];
      if (a.end.load(std::memory_order_relaxed) < pos) break;
      ns = a.ns.load(std::memory_order_relaxed);
      --i;
    }
    if (i == lo && lo > 0) return -1;   // the put before it is overwritten
    // entries read from index i - 1 (or i) on are valid only if the
    // producer has not begun to overwrite them meanwhile
    std::atomic_thread_fence(std::memory_order_acquire);
    size_t n2 = log_n_.load(std::memory_order_relaxed);
    size_t oldest = i > 0 ? i - 1 : 0;
    if (n2 >= oldest + kLog) return -1;
    return ns;
  }

  static int64_t steady_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  }

 private:
  static constexpr size_t kLog = 256;
  struct Arrival {
    std::atomic<size_t> end{0};   // elements received in all after the put
    std::atomic<int64_t> ns{0};
  };

  size_t mask_;
  std::vector<T> buf_;
  std::atomic<size_t> head_{0};  // written by producer
  std::atomic<size_t> tail_{0};  // written by consumer
  Arrival log_[kLog];
  std::atomic<size_t> log_n_{0};  // puts logged in all
};

}  // namespace sdrjfm
