// Seeded normal draws, bit for bit NumPy's legacy stream
// `numpy.random.RandomState(seed).normal(loc, scale, n)`, on the host's
// threads.
//
// The legacy stream is MT19937 seeded by `init_genrand(seed)`, read by the
// polar method: an attempt takes two doubles of two words each,
// x = 2 * ((a >> 5) * 2^26 + (b >> 6)) / 2^53 - 1, and is kept when
// r2 = x1^2 + x2^2 lies in (0, 1); a kept attempt j gives the normals
// f * x2 and f * x1, f = sqrt(-2 log(r2) / r2), in slots 2j and 2j + 1,
// each as loc + scale * g in double. Attempt t reads words 4t .. 4t + 3
// whatever the others did, so one twisted block of 624 words holds exactly
// 156 attempts, and only two things are sequential: the twist (block b + 1
// from block b) and the running count of kept attempts that places each
// output. So per stream one thread twists the blocks into a buffer while
// the others take ranges of blocks in order: each counts the kept attempts
// of its range, adds the count to the running offset once the range before
// it has, then writes its outputs from there. Attempts past the estimated
// blocks (the count fell short) are drawn one by one after the last range.
//
// The tempering, the doubles, the accept test, the transform and the cast
// are NumPy's operations in NumPy's order, with libm's log and sqrt, and
// nothing contracted into a fused multiply-add (g++ builds this file with
// -ffp-contract=off; the pragma says the same to clang).
//
// Exposed with a plain C ABI for ctypes.

#ifdef __clang__
#pragma STDC FP_CONTRACT OFF
#endif

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>

namespace {

constexpr int N = 624;
constexpr int M = 397;
constexpr uint32_t MATRIX_A = 0x9908b0dfU;
constexpr uint32_t UPPER = 0x80000000U;
constexpr uint32_t LOWER = 0x7fffffffU;
constexpr int64_t ATTEMPTS_PER_BLOCK = N / 4;
constexpr int64_t RANGE_BLOCKS = 16;  // blocks a worker takes at once
constexpr double ACCEPT = 0.78539816339744830962;  // pi / 4

inline uint32_t mix(uint32_t hi, uint32_t lo) {
  const uint32_t y = (hi & UPPER) | (lo & LOWER);
  return (y >> 1) ^ (-(y & 1U) & MATRIX_A);
}

// init_genrand(seed): NumPy's mt19937_seed.
void seed_state(uint32_t seed, uint32_t* key) {
  key[0] = seed;
  for (int i = 1; i < N; ++i)
    key[i] = 1812433253U * (key[i - 1] ^ (key[i - 1] >> 30)) +
             static_cast<uint32_t>(i);
}

// The state after one twist of `in`, written to `out`: NumPy's in-place
// mt19937_gen, whose later words read earlier words already replaced.
void twist(const uint32_t* __restrict in, uint32_t* __restrict out) {
  for (int i = 0; i < N - M; ++i) out[i] = in[i + M] ^ mix(in[i], in[i + 1]);
  for (int i = N - M; i < N - 1; ++i)
    out[i] = out[i - (N - M)] ^ mix(in[i], in[i + 1]);
  out[N - 1] = out[M - 1] ^ mix(in[N - 1], out[0]);
}

inline uint32_t temper(uint32_t y) {
  y ^= (y >> 11);
  y ^= (y << 7) & 0x9d2c5680U;
  y ^= (y << 15) & 0xefc60000U;
  y ^= (y >> 18);
  return y;
}

// mt19937_next_double of two consecutive words.
inline double unit(uint32_t wa, uint32_t wb) {
  const int32_t a = static_cast<int32_t>(temper(wa) >> 5);
  const int32_t b = static_cast<int32_t>(temper(wb) >> 6);
  return (a * 67108864.0 + b) / 9007199254740992.0;
}

// One polar attempt on words w[0..3]: true when kept.
inline bool attempt(const uint32_t* w, double& x1, double& x2, double& r2) {
  x1 = 2.0 * unit(w[0], w[1]) - 1.0;
  x2 = 2.0 * unit(w[2], w[3]) - 1.0;
  r2 = x1 * x1 + x2 * x2;
  return !(r2 >= 1.0 || r2 == 0.0);
}

template <typename T>
inline void emit(T* out, int64_t j, int64_t n, double loc, double scale,
                 double x1, double x2, double r2) {
  const double f = std::sqrt(-2.0 * std::log(r2) / r2);
  out[2 * j] = static_cast<T>(loc + scale * (f * x2));
  if (2 * j + 1 < n) out[2 * j + 1] = static_cast<T>(loc + scale * (f * x1));
}

struct Stream {
  uint32_t* words = nullptr;           // blocks * N twisted words
  uint32_t seed = 0;
  int64_t blocks = 0;
  int64_t ranges = 0;
  std::atomic<int64_t> ready{0};       // blocks twisted so far
  std::atomic<int64_t> frontier{0};    // ranges whose offset is known
  std::vector<int64_t> offset;         // kept attempts before each range
};

struct Job {
  std::vector<Stream> streams;
  int64_t n = 0;                        // normals per stream
  int64_t pairs = 0;                    // kept attempts a stream needs
  double loc = 0.0, scale = 1.0;
  void* out = nullptr;
  bool f32 = true;
  std::atomic<int64_t> next_twist{0};
  std::atomic<int64_t> next_range{0};
};

void spin_until(const std::atomic<int64_t>& a, int64_t at_least) {
  while (a.load(std::memory_order_acquire) < at_least)
    std::this_thread::yield();
}

void twist_stream(Stream& s) {
  uint32_t state[N];
  seed_state(s.seed, state);
  const uint32_t* prev = state;
  for (int64_t b = 0; b < s.blocks; ++b) {
    uint32_t* cur = s.words + b * N;
    twist(prev, cur);
    prev = cur;
    s.ready.store(b + 1, std::memory_order_release);
  }
}

// Attempts past the stream's blocks, one by one from the last block's
// state, until the stream has its `pairs` kept attempts.
template <typename T>
void tail(const Job& job, const Stream& s, int64_t kept, T* out) {
  uint32_t key[N], next[N];
  std::copy(s.words + (s.blocks - 1) * N, s.words + s.blocks * N, key);
  while (kept < job.pairs) {
    twist(key, next);
    std::copy(next, next + N, key);
    for (int64_t a = 0; a < ATTEMPTS_PER_BLOCK && kept < job.pairs; ++a) {
      double x1, x2, r2;
      if (attempt(key + 4 * a, x1, x2, r2))
        emit(out, kept++, job.n, job.loc, job.scale, x1, x2, r2);
    }
  }
}

template <typename T>
void range(Job& job, Stream& s, int64_t r, T* out) {
  const int64_t b0 = r * RANGE_BLOCKS;
  const int64_t b1 = std::min(s.blocks, b0 + RANGE_BLOCKS);
  spin_until(s.ready, b1);
  const uint32_t* w0 = s.words + b0 * N;
  const int64_t attempts = (b1 - b0) * ATTEMPTS_PER_BLOCK;
  int64_t kept = 0;
  for (int64_t a = 0; a < attempts; ++a) {
    double x1, x2, r2;
    kept += attempt(w0 + 4 * a, x1, x2, r2);
  }
  spin_until(s.frontier, r);
  const int64_t start = s.offset[r];
  s.offset[r + 1] = start + kept;
  s.frontier.store(r + 1, std::memory_order_release);
  if (start < job.pairs) {
    int64_t j = start;
    for (int64_t a = 0; a < attempts && j < job.pairs; ++a) {
      double x1, x2, r2;
      if (attempt(w0 + 4 * a, x1, x2, r2))
        emit(out, j++, job.n, job.loc, job.scale, x1, x2, r2);
    }
  }
  if (r + 1 == s.ranges && start + kept < job.pairs)
    tail(job, s, start + kept, out);
}

// Twist tasks first (each thread that takes one twists a whole stream and
// never waits), then ranges in order across streams; a range waits only
// for its own blocks and for the ranges of its stream before it, which
// earlier tasks hold, so the work always moves.
void work(Job& job) {
  const int64_t k = static_cast<int64_t>(job.streams.size());
  for (int64_t s; (s = job.next_twist.fetch_add(1)) < k;)
    twist_stream(job.streams[s]);
  const int64_t tasks = k * job.streams[0].ranges;
  for (int64_t t; (t = job.next_range.fetch_add(1)) < tasks;) {
    const int64_t s = t % k, r = t / k;
    if (job.f32) {
      range(job, job.streams[s], r,
            static_cast<float*>(job.out) + s * job.n);
    } else {
      range(job, job.streams[s], r,
            static_cast<double*>(job.out) + s * job.n);
    }
  }
}

}  // namespace

extern "C" {

// out: k * n values, stream i in out[i * n, (i + 1) * n), as float
// (out_f32 != 0) or double; seeds: k values of NumPy's legacy seeding;
// threads: the threads to run on (the caller's included), at least 1.
void lcx_seeded_normal(const uint32_t* seeds, int64_t k, int64_t n,
                       double loc, double scale, int32_t out_f32, void* out,
                       int64_t threads) {
  if (k <= 0 || n <= 0) return;
  Job job;
  job.n = n;
  job.pairs = (n + 1) / 2;
  job.loc = loc;
  job.scale = scale;
  job.out = out;
  job.f32 = out_f32 != 0;
  const int64_t attempts =
      static_cast<int64_t>(std::ceil(static_cast<double>(job.pairs) / ACCEPT));
  const int64_t blocks =
      std::max<int64_t>(1, (attempts + ATTEMPTS_PER_BLOCK - 1) /
                               ATTEMPTS_PER_BLOCK);
  // the twisted words, left unset: each is written before it is read
  const std::unique_ptr<uint32_t[]> words(new uint32_t[k * blocks * N]);

  job.streams = std::vector<Stream>(static_cast<size_t>(k));
  for (int64_t i = 0; i < k; ++i) {
    Stream& s = job.streams[i];
    s.words = words.get() + i * blocks * N;
    s.seed = seeds[i];
    s.blocks = blocks;
    s.ranges = (blocks + RANGE_BLOCKS - 1) / RANGE_BLOCKS;
    s.offset.assign(static_cast<size_t>(s.ranges + 1), 0);
  }
  const int64_t helpers = std::max<int64_t>(1, threads) - 1;
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(helpers));
  for (int64_t i = 0; i < helpers; ++i) pool.emplace_back(work, std::ref(job));
  work(job);
  for (auto& t : pool) t.join();
}

}  // extern "C"
