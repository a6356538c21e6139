// Lock-free single-producer/single-consumer ring buffer.
//
// Role model: the reference's portaudio-derived SPSC ring
// (includes/various/ringbuffer.h — power-of-2 size, acquire/release
// ordering) which every device handler uses to hand samples to the DSP
// thread.  This is a fresh implementation on std::atomic with the same
// contract: one writer thread, one reader thread, no locks.
#pragma once

#include <atomic>
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

 private:
  size_t mask_;
  std::vector<T> buf_;
  std::atomic<size_t> head_{0};  // written by producer
  std::atomic<size_t> tail_{0};  // written by consumer
};

}  // namespace sdrjfm
