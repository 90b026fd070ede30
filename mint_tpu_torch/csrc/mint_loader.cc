// Native training data loader: TFRecord framing + tf.train.Example wire
// parsing + FACT windowing + shuffle buffer, behind a C API (ctypes).
//
// The port's own copy of the JAX package's C++ loader, whose code it
// keeps line for line, so that both yield the same batches bit for bit
// from the same shards and seed.  It is the
// host runtime the reference delegates to TF's C++ tf.data stack
// (reference mint/core/inputs.py:63-122): interleaved shard reading,
// shuffle(100), per-example random window sampling
// (mint/utils/inputs_util.py:74-103: pad motion 219->225 with 6 leading
// zeros, window = max(motion_in, shift+target, audio_in)), fixed-size
// batches with drop-remainder.  A background reader thread parses and
// fills the shuffle buffer while the card consumes batches.
//
// Protocol details implemented here:
// - TFRecord framing: {u64 len, u32 masked_crc(len), bytes, u32
//   masked_crc(bytes)} with CRC32C (Castagnoli), mask
//   ((crc >> 15 | crc << 17) + 0xa282ead8).
// - tf.train.Example wire format: Example{1: Features{1: map<string,
//   Feature>}}, Feature oneof {1: BytesList, 2: FloatList, 3: Int64List},
//   each list field 1 (packed or unpacked).
//
// Build: mint_tpu_torch/data/native_loader.py runs g++ at first use
// (g++ -O3 -std=c++17 -fPIC -Wall -pthread -shared mint_loader.cc) into
// mint_tpu_torch/_build/, keyed by a hash of this source and the flags.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CRC32C
// ---------------------------------------------------------------------------

uint32_t g_crc_table[256];
bool g_crc_init = [] {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? (0x82f63b78u ^ (c >> 1)) : (c >> 1);
    g_crc_table[i] = c;
  }
  return true;
}();

uint32_t Crc32c(const uint8_t* data, size_t n) {
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; ++i)
    c = g_crc_table[(c ^ data[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

uint32_t MaskedCrc(const uint8_t* data, size_t n) {
  uint32_t crc = Crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// ---------------------------------------------------------------------------
// Protobuf wire helpers
// ---------------------------------------------------------------------------

struct Slice {
  const uint8_t* p = nullptr;
  size_t n = 0;
};

bool ReadVarint(const uint8_t*& p, const uint8_t* end, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    v |= uint64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return true;
    }
    shift += 7;
  }
  return false;
}

bool SkipField(const uint8_t*& p, const uint8_t* end, uint32_t wire) {
  uint64_t tmp;
  switch (wire) {
    case 0: return ReadVarint(p, end, &tmp);
    case 1: if (end - p < 8) return false; p += 8; return true;
    case 2:
      if (!ReadVarint(p, end, &tmp) || uint64_t(end - p) < tmp) return false;
      p += tmp;
      return true;
    case 5: if (end - p < 4) return false; p += 4; return true;
    default: return false;
  }
}

// Iterate fields of a message slice; cb(field_no, wire, value_slice_or_varint)
template <typename F>
bool ForEachField(Slice msg, F&& cb) {
  const uint8_t* p = msg.p;
  const uint8_t* end = msg.p + msg.n;
  while (p < end) {
    uint64_t tag;
    if (!ReadVarint(p, end, &tag)) return false;
    uint32_t field = uint32_t(tag >> 3), wire = uint32_t(tag & 7);
    if (wire == 2) {
      uint64_t len;
      if (!ReadVarint(p, end, &len) || uint64_t(end - p) < len) return false;
      cb(field, wire, Slice{p, size_t(len)}, 0);
      p += len;
    } else if (wire == 0) {
      uint64_t v;
      if (!ReadVarint(p, end, &v)) return false;
      cb(field, wire, Slice{}, v);
    } else {
      const uint8_t* q = p;
      if (!SkipField(p, end, wire)) return false;
      cb(field, wire, Slice{q, size_t(p - q)}, 0);
    }
  }
  return true;
}

// Parse a FloatList/Int64List message (field 1 repeated, packed or not).
void ParseFloatList(Slice list, std::vector<float>* out) {
  ForEachField(list, [&](uint32_t field, uint32_t wire, Slice s, uint64_t v) {
    if (field != 1) return;
    if (wire == 2) {  // packed
      size_t n = s.n / 4;
      size_t base = out->size();
      out->resize(base + n);
      std::memcpy(out->data() + base, s.p, n * 4);
    } else if (wire == 5) {
      float f;
      std::memcpy(&f, s.p, 4);
      out->push_back(f);
    }
  });
}

void ParseInt64List(Slice list, std::vector<int64_t>* out) {
  ForEachField(list, [&](uint32_t field, uint32_t wire, Slice s, uint64_t v) {
    if (field != 1) return;
    if (wire == 0) {
      out->push_back(int64_t(v));
    } else if (wire == 2) {  // packed varints
      const uint8_t* p = s.p;
      const uint8_t* end = s.p + s.n;
      uint64_t x;
      while (p < end && ReadVarint(p, end, &x)) out->push_back(int64_t(x));
    }
  });
}

struct Example {
  std::vector<float> motion;        // [t_motion * motion_dim]
  std::vector<float> audio;         // [t_audio * audio_dim]
  int64_t t_motion = 0, motion_dim = 0;
  int64_t t_audio = 0, audio_dim = 0;
};

// Extract the FACT features from a serialized tf.train.Example.
bool ParseExample(Slice record, Example* ex) {
  Slice features{};
  ForEachField(record, [&](uint32_t f, uint32_t w, Slice s, uint64_t) {
    if (f == 1 && w == 2) features = s;  // Example.features
  });
  if (!features.p) return false;

  std::vector<int64_t> mshape, ashape;
  bool ok = ForEachField(features, [&](uint32_t f, uint32_t w, Slice entry,
                                       uint64_t) {
    if (f != 1 || w != 2) return;  // map entry
    Slice key{}, value{};
    ForEachField(entry, [&](uint32_t ef, uint32_t ew, Slice s, uint64_t) {
      if (ef == 1 && ew == 2) key = s;
      if (ef == 2 && ew == 2) value = s;
    });
    if (!key.p || !value.p) return;
    std::string name(reinterpret_cast<const char*>(key.p), key.n);
    // Feature oneof: 2 = float_list, 3 = int64_list.
    ForEachField(value, [&](uint32_t vf, uint32_t vw, Slice s, uint64_t) {
      if (vw != 2) return;
      if (vf == 2 && name == "motion_sequence") ParseFloatList(s, &ex->motion);
      if (vf == 2 && name == "audio_sequence") ParseFloatList(s, &ex->audio);
      if (vf == 3 && name == "motion_sequence_shape")
        ParseInt64List(s, &mshape);
      if (vf == 3 && name == "audio_sequence_shape")
        ParseInt64List(s, &ashape);
    });
  });
  if (!ok) return false;
  if (mshape.size() == 2) {
    ex->t_motion = mshape[0];
    ex->motion_dim = mshape[1];
  }
  if (ashape.size() == 2) {
    ex->t_audio = ashape[0];
    ex->audio_dim = ashape[1];
  }
  if (ex->t_motion <= 0 || ex->t_audio <= 0 || ex->motion_dim <= 0 ||
      ex->audio_dim <= 0) {
    return false;
  }
  // Shape metadata must agree with the actual float payload — a
  // truncated or inconsistent record would otherwise drive memcpy past
  // the vector's allocation in MakeWindow.
  if (ex->motion.size() != size_t(ex->t_motion) * size_t(ex->motion_dim))
    return false;
  if (ex->audio.size() != size_t(ex->t_audio) * size_t(ex->audio_dim))
    return false;
  return true;
}

// ---------------------------------------------------------------------------
// Loader
// ---------------------------------------------------------------------------

struct Config {
  int batch_size;
  int motion_input_len, target_len, target_shift, audio_input_len;
  int motion_dim_raw, audio_dim;  // 219, 35
  int shuffle_buffer;             // 100 (reference inputs.py:70)
  uint64_t seed;
  // Decoded-record cache budget in bytes (0 = stream every epoch).  One
  // windowed example costs a full record read + CRC + proto parse
  // (~1.5 MB for a 25 s AIST++ sequence) but yields a ~130 KB window; a
  // typical corpus fits in a couple of GB of RAM, so epochs after the
  // first sample windows straight from decoded floats.  If the corpus
  // outgrows the budget mid-fill, the cache is dropped and the loader
  // streams forever (identical semantics, original speed).
  uint64_t cache_bytes;
};

struct Window {  // one training example, already windowed + padded
  std::vector<float> motion_input;  // [motion_input_len, motion_dim_raw+6]
  std::vector<float> target;        // [target_len, motion_dim_raw+6]
  std::vector<float> audio_input;   // [audio_input_len, audio_dim]
};

class Loader {
 public:
  Loader(std::vector<std::string> files, Config cfg)
      : files_(std::move(files)), cfg_(cfg), rng_(cfg.seed) {
    caching_ = cfg_.cache_bytes > 0;
    reader_ = std::thread([this] { ReadLoop(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_not_full_.notify_all();
    cv_not_empty_.notify_all();
    if (reader_.joinable()) reader_.join();
  }

  // Fill caller-provided batch buffers; returns rows filled (0 = stopped).
  int Next(float* motion, float* audio, float* target) {
    const int bs = cfg_.batch_size;
    const int mdim = cfg_.motion_dim_raw + 6;
    for (int row = 0; row < bs; ++row) {
      Window w;
      {
        std::unique_lock<std::mutex> lock(mu_);
        // tf.data shuffle(buffer) parity (reference inputs.py:70): the
        // buffer FILLS before anything is yielded and is kept full
        // between pops, so every sample is drawn uniformly from a full
        // buffer — popping as soon as one element existed made the
        // first ~buffer examples come out in near file order.  On
        // exhaustion (stop_) the remaining buffer drains.
        cv_not_empty_.wait(lock, [this] {
          return stop_ ||
                 buffer_.size() >= size_t(cfg_.shuffle_buffer);
        });
        if (stop_ && buffer_.empty()) return 0;
        // shuffle(100): pop a random element.
        std::uniform_int_distribution<size_t> d(0, buffer_.size() - 1);
        size_t idx = d(rng_);
        w = std::move(buffer_[idx]);
        buffer_[idx] = std::move(buffer_.back());
        buffer_.pop_back();
      }
      cv_not_full_.notify_one();
      std::memcpy(motion + size_t(row) * cfg_.motion_input_len * mdim,
                  w.motion_input.data(), w.motion_input.size() * 4);
      std::memcpy(target + size_t(row) * cfg_.target_len * mdim,
                  w.target.data(), w.target.size() * 4);
      std::memcpy(audio + size_t(row) * cfg_.audio_input_len * cfg_.audio_dim,
                  w.audio_input.data(), w.audio_input.size() * 4);
    }
    return bs;
  }

 private:
  void ReadLoop() {
    std::mt19937_64 file_rng(cfg_.seed ^ 0x9e3779b97f4a7c15ull);
    // Endless epochs (reference .repeat()), shards reshuffled per epoch.
    bool first_epoch = true;
    while (true) {
      {
        std::lock_guard<std::mutex> lock(mu_);
        if (stop_) return;
      }
      bool produced = false;
      if (cache_complete_) {
        // Window directly from decoded floats; no disk/CRC/proto work.
        std::vector<size_t> order(cache_.size());
        for (size_t i = 0; i < order.size(); ++i) order[i] = i;
        std::shuffle(order.begin(), order.end(), file_rng);
        for (size_t ei : order) {
          Window w;
          if (!MakeWindow(cache_[ei], file_rng, &w)) continue;
          if (!Enqueue(std::move(w))) return;
          produced = true;
        }
      } else {
        std::vector<size_t> order(files_.size());
        for (size_t i = 0; i < order.size(); ++i) order[i] = i;
        std::shuffle(order.begin(), order.end(), file_rng);
        for (size_t fi : order) {
          if (!ReadFile(files_[fi], file_rng, first_epoch, &produced))
            return;
        }
        if (first_epoch && caching_) cache_complete_ = true;
        first_epoch = false;
      }
      if (!produced) {
        // No shard yielded a single usable window: signal exhaustion so
        // Next() returns 0 instead of blocking forever.
        {
          std::lock_guard<std::mutex> lock(mu_);
          stop_ = true;
        }
        cv_not_empty_.notify_all();
        return;
      }
    }
  }

  // Blocks until the shuffle buffer has room; returns false on stop.
  bool Enqueue(Window w) {
    std::unique_lock<std::mutex> lock(mu_);
    cv_not_full_.wait(lock, [this] {
      return stop_ || buffer_.size() < size_t(cfg_.shuffle_buffer);
    });
    if (stop_) return false;
    buffer_.push_back(std::move(w));
    lock.unlock();
    cv_not_empty_.notify_one();
    return true;
  }

  // Returns false if the loader is stopping; sets *produced when at
  // least one window was enqueued from this shard.  On the first epoch
  // parse-valid examples are added to the decoded cache (until the
  // byte budget overflows, which drops the cache for good).
  bool ReadFile(const std::string& path, std::mt19937_64& rng,
                bool cache_this_epoch, bool* produced) {
    std::ifstream in(path, std::ios::binary);
    if (!in) return true;  // skip unreadable shard
    std::vector<uint8_t> buf;
    while (true) {
      uint8_t header[12];
      if (!in.read(reinterpret_cast<char*>(header), 12)) break;
      uint64_t len;
      uint32_t len_crc;
      std::memcpy(&len, header, 8);
      std::memcpy(&len_crc, header + 8, 4);
      // Verify the length CRC (TFRecord's guard against corrupt/desynced
      // framing): a flipped length would otherwise drive a huge resize
      // and kill the process from the reader thread.
      if (MaskedCrc(header, 8) != len_crc) break;
      if (len > (1ull << 31)) break;  // sane record-size cap (2 GB)
      buf.resize(len + 4);
      if (!in.read(reinterpret_cast<char*>(buf.data()), len + 4)) break;
      // Verify the record-data CRC (trailing u32) like TF's RecordReader:
      // a corrupted payload with intact framing must not be consumed as
      // training data.
      uint32_t data_crc;
      std::memcpy(&data_crc, buf.data() + len, 4);
      if (MaskedCrc(buf.data(), len) != data_crc) break;

      Example ex;
      if (!ParseExample(Slice{buf.data(), size_t(len)}, &ex)) continue;
      Window w;
      bool windowed = MakeWindow(ex, rng, &w);
      if (caching_ && cache_this_epoch) {
        cache_used_ += (ex.motion.capacity() + ex.audio.capacity()) * 4 +
                       sizeof(Example);
        if (cache_used_ > cfg_.cache_bytes) {
          caching_ = false;
          cache_.clear();
          cache_.shrink_to_fit();
        } else {
          cache_.push_back(std::move(ex));
        }
      }
      if (!windowed) continue;
      if (!Enqueue(std::move(w))) return false;
      *produced = true;
    }
    return true;
  }

  // FACT windowing (inputs_util.py:74-103): pad 219->225, one random
  // window per example.
  bool MakeWindow(const Example& ex, std::mt19937_64& rng, Window* w) {
    const int mdim_raw = cfg_.motion_dim_raw;
    const int mdim = mdim_raw + 6;
    if (ex.motion_dim != mdim_raw || ex.audio_dim != cfg_.audio_dim)
      return false;
    int64_t window = std::max<int64_t>(
        {cfg_.motion_input_len,
         int64_t(cfg_.target_shift) + cfg_.target_len,
         cfg_.audio_input_len});
    int64_t hi = ex.t_motion - window + 1;
    if (hi <= 0 || ex.t_audio < window) return false;
    std::uniform_int_distribution<int64_t> d(0, hi - 1);
    int64_t start = d(rng);
    if (start >= ex.t_audio) return false;  // audio shorter than motion

    auto slice_motion = [&](int64_t s, int len, std::vector<float>* out) {
      out->assign(size_t(len) * mdim, 0.0f);
      for (int t = 0; t < len; ++t) {
        if (s + t >= ex.t_motion) break;
        std::memcpy(out->data() + size_t(t) * mdim + 6,
                    ex.motion.data() + (s + t) * mdim_raw, mdim_raw * 4);
      }
    };
    slice_motion(start, cfg_.motion_input_len, &w->motion_input);
    slice_motion(start + cfg_.target_shift, cfg_.target_len, &w->target);
    w->audio_input.assign(size_t(cfg_.audio_input_len) * cfg_.audio_dim,
                          0.0f);
    // Clamp to >= 0: a negative remainder cast to size_t would memcpy
    // petabytes (audio shorter than the sampled window start).
    int64_t audio_avail = std::max<int64_t>(
        0, std::min<int64_t>(cfg_.audio_input_len, ex.t_audio - start));
    std::memcpy(w->audio_input.data(),
                ex.audio.data() + start * cfg_.audio_dim,
                size_t(audio_avail) * cfg_.audio_dim * 4);
    return true;
  }

  std::vector<std::string> files_;
  Config cfg_;
  std::mt19937_64 rng_;
  std::vector<Window> buffer_;
  std::mutex mu_;
  std::condition_variable cv_not_empty_, cv_not_full_;
  bool stop_ = false;
  // Decoded-record cache (reader thread only; no locking needed).
  std::vector<Example> cache_;
  uint64_t cache_used_ = 0;
  bool caching_ = false;         // still filling (set from cfg in ctor)
  bool cache_complete_ = false;  // first epoch fit; serve from memory
  std::thread reader_;
};

}  // namespace

extern "C" {

void* mint_loader_open(const char** files, int n_files, int batch_size,
                       int motion_input_len, int target_len,
                       int target_shift, int audio_input_len,
                       int motion_dim_raw, int audio_dim,
                       int shuffle_buffer, uint64_t seed,
                       uint64_t cache_bytes) {
  std::vector<std::string> fs(files, files + n_files);
  Config cfg{batch_size, motion_input_len, target_len, target_shift,
             audio_input_len, motion_dim_raw, audio_dim, shuffle_buffer,
             seed, cache_bytes};
  return new Loader(std::move(fs), cfg);
}

int mint_loader_next(void* handle, float* motion, float* audio,
                     float* target) {
  return static_cast<Loader*>(handle)->Next(motion, audio, target);
}

void mint_loader_close(void* handle) { delete static_cast<Loader*>(handle); }

// TFRecord CRC32C exposed for testing.
uint32_t mint_masked_crc32c(const uint8_t* data, size_t n) {
  return MaskedCrc(data, n);
}

}  // extern "C"
