// Native audio data loader: WAV decode + random-crop batching with
// background prefetch threads (the port's copy of native/dataloader.cpp,
// the same code).
//
// Decodes 8/16/24/32-bit PCM and float WAVs, mono-mixes, caches decoded
// signals in memory, and keeps a ring of ready batches filled by worker
// threads so that the device never waits on host IO. Each worker draws
// from its own generator (seed + 7919 * thread), so batches come in a
// fixed order only with one thread.
//
// C API (ctypes-friendly):
//   void* loader_create(const char** paths, int n_paths, int batch_size,
//                       int n_samples, int step_size, int normalize,
//                       unsigned seed, int n_prefetch, int n_threads);
//   int   loader_next(void* handle, float* out);    // blocking; 0 on ok
//   int   loader_batch_size(void* handle);
//   int   loader_n_samples(void* handle);
//   void  loader_destroy(void* handle);
//
// Built at first use by mptpu_torch/data/native.py with
// g++ -O3 -std=c++17 -fPIC -pthread -shared into build/mptpu_torch_native/.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Wav {
    std::vector<float> samples;  // mono
    int samplerate = 0;
};

bool read_wav(const std::string& path, Wav& out) {
    std::ifstream f(path, std::ios::binary);
    if (!f) return false;
    char riff[12];
    f.read(riff, 12);
    if (f.gcount() != 12 || std::memcmp(riff, "RIFF", 4) != 0 ||
        std::memcmp(riff + 8, "WAVE", 4) != 0)
        return false;

    uint16_t format = 0, channels = 0, bits = 0;
    uint32_t samplerate = 0;
    std::vector<char> data;

    while (f) {
        char hdr[8];
        f.read(hdr, 8);
        if (f.gcount() != 8) break;
        uint32_t size;
        std::memcpy(&size, hdr + 4, 4);
        if (std::memcmp(hdr, "fmt ", 4) == 0) {
            std::vector<char> fmt(size);
            f.read(fmt.data(), size);
            std::memcpy(&format, fmt.data(), 2);
            std::memcpy(&channels, fmt.data() + 2, 2);
            std::memcpy(&samplerate, fmt.data() + 4, 4);
            std::memcpy(&bits, fmt.data() + 14, 2);
            if (format == 0xFFFE && size >= 26)
                std::memcpy(&format, fmt.data() + 24, 2);
        } else if (std::memcmp(hdr, "data", 4) == 0) {
            data.resize(size);
            f.read(data.data(), size);
        } else {
            f.seekg(size + (size & 1), std::ios::cur);
            continue;
        }
        if (size & 1) f.seekg(1, std::ios::cur);
    }
    if (data.empty() || channels == 0) return false;

    size_t frame_bytes = (bits / 8) * channels;
    size_t n_frames = data.size() / frame_bytes;
    out.samples.resize(n_frames);
    out.samplerate = static_cast<int>(samplerate);

    const unsigned char* p =
        reinterpret_cast<const unsigned char*>(data.data());
    for (size_t i = 0; i < n_frames; ++i) {
        double acc = 0.0;
        for (int c = 0; c < channels; ++c) {
            const unsigned char* s = p + i * frame_bytes + c * (bits / 8);
            double v = 0.0;
            if (format == 1) {  // PCM
                if (bits == 16) {
                    int16_t x;
                    std::memcpy(&x, s, 2);
                    v = x / 32768.0;
                } else if (bits == 24) {
                    int32_t x = s[0] | (s[1] << 8) | (s[2] << 16);
                    if (x >= (1 << 23)) x -= (1 << 24);
                    v = x / 8388608.0;
                } else if (bits == 32) {
                    int32_t x;
                    std::memcpy(&x, s, 4);
                    v = x / 2147483648.0;
                } else if (bits == 8) {
                    v = (s[0] - 128) / 128.0;
                }
            } else if (format == 3) {  // IEEE float
                if (bits == 32) {
                    float x;
                    std::memcpy(&x, s, 4);
                    v = x;
                } else if (bits == 64) {
                    double x;
                    std::memcpy(&x, s, 8);
                    v = x;
                }
            }
            acc += v;
        }
        out.samples[i] = static_cast<float>(acc / channels);
    }
    return true;
}

struct Loader {
    std::vector<std::string> paths;
    std::vector<Wav> cache;           // decoded lazily, index-aligned
    std::vector<std::once_flag> decoded;
    int batch_size, n_samples, step_size, normalize;
    int n_prefetch;
    std::atomic<bool> stop{false};

    std::deque<std::vector<float>> ready;
    std::mutex mu;
    std::condition_variable cv_ready, cv_space;
    std::vector<std::thread> workers;
    std::atomic<uint64_t> seq{0};
    unsigned seed;

    const Wav& get(size_t idx) {
        std::call_once(decoded[idx], [this, idx] {
            read_wav(paths[idx], cache[idx]);
        });
        return cache[idx];
    }

    void fill_batch(std::vector<float>& out, std::mt19937& rng) {
        out.resize(static_cast<size_t>(batch_size) * n_samples);
        std::uniform_int_distribution<size_t> pick(0, paths.size() - 1);
        for (int b = 0; b < batch_size; ++b) {
            float* row = out.data() + static_cast<size_t>(b) * n_samples;
            const Wav& w = get(pick(rng));
            const auto& s = w.samples;
            if (s.empty()) {
                std::memset(row, 0, sizeof(float) * n_samples);
                continue;
            }
            // pad virtually so any file yields a window (reference
            // datastore.py:136-139)
            long long total = std::max<long long>(
                (long long)s.size(), 2LL * n_samples);
            // clamp: step_size > n_samples on a short file can make this 0,
            // and uniform_int_distribution(0, -1) is undefined behavior
            long long positions =
                std::max(1LL, (total - n_samples) / step_size);
            std::uniform_int_distribution<long long> startd(0, positions - 1);
            long long start = startd(rng) * step_size;
            for (int i = 0; i < n_samples; ++i) {
                long long j = start + i;
                row[i] = (j < (long long)s.size()) ? s[j] : 0.0f;
            }
            if (normalize) {
                float mx = 1e-12f;
                for (int i = 0; i < n_samples; ++i)
                    mx = std::max(mx, std::abs(row[i]));
                for (int i = 0; i < n_samples; ++i) row[i] /= mx;
            }
        }
    }

    void worker(unsigned wseed) {
        std::mt19937 rng(wseed);
        while (!stop.load()) {
            std::vector<float> batch;
            fill_batch(batch, rng);
            std::unique_lock<std::mutex> lk(mu);
            cv_space.wait(lk, [this] {
                return stop.load() || (int)ready.size() < n_prefetch;
            });
            if (stop.load()) return;
            ready.push_back(std::move(batch));
            cv_ready.notify_one();
        }
    }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n_paths, int batch_size,
                    int n_samples, int step_size, int normalize,
                    unsigned seed, int n_prefetch, int n_threads) {
    if (n_paths <= 0 || batch_size <= 0 || n_samples <= 0) return nullptr;
    auto* L = new Loader();
    L->paths.assign(paths, paths + n_paths);
    L->cache.resize(n_paths);
    L->decoded = std::vector<std::once_flag>(n_paths);
    L->batch_size = batch_size;
    L->n_samples = n_samples;
    L->step_size = step_size > 0 ? step_size : 1;
    L->normalize = normalize;
    L->n_prefetch = n_prefetch > 0 ? n_prefetch : 4;
    L->seed = seed;
    int nt = n_threads > 0 ? n_threads : 1;
    for (int t = 0; t < nt; ++t)
        L->workers.emplace_back(&Loader::worker, L, seed + 7919u * t);
    return L;
}

int loader_next(void* handle, float* out) {
    auto* L = static_cast<Loader*>(handle);
    if (!L) return -1;
    std::vector<float> batch;
    {
        std::unique_lock<std::mutex> lk(L->mu);
        L->cv_ready.wait(lk, [L] { return L->stop.load() || !L->ready.empty(); });
        if (L->stop.load()) return -1;
        batch = std::move(L->ready.front());
        L->ready.pop_front();
        L->cv_space.notify_one();
    }
    std::memcpy(out, batch.data(), batch.size() * sizeof(float));
    return 0;
}

int loader_batch_size(void* handle) {
    return static_cast<Loader*>(handle)->batch_size;
}

int loader_n_samples(void* handle) {
    return static_cast<Loader*>(handle)->n_samples;
}

void loader_destroy(void* handle) {
    auto* L = static_cast<Loader*>(handle);
    if (!L) return;
    L->stop.store(true);
    L->cv_space.notify_all();
    L->cv_ready.notify_all();
    for (auto& t : L->workers) t.join();
    delete L;
}

}  // extern "C"
