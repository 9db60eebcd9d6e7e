// Native host-side data pipeline: memory-mapped tensor cache with a
// thread-pool batch assembler.
//
// Role: the reference feeds training from PIL + torch DataLoader workers
// (dataset.py, n_workers=0 -> decode on the training thread).  Here decoded
// images are cached once into a flat binary file; training epochs then
// assemble batches off the mmap with C++ threads (no GIL, no Python object
// churn), converting uint8 -> float32 [-1, 1] on the fly.  Exposed via a C
// ABI consumed through ctypes (gan2shape_torch/native/__init__.py).
//
// Layout of a cache file: raw C-order records, record i at offset
// i * c*h*w * dtype_size.  dtype: 0 = uint8 (scaled to [-1,1]), 1 = float32
// (copied through).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <mutex>
#include <queue>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Cache {
    int fd = -1;
    const uint8_t* base = nullptr;
    size_t file_size = 0;
    int64_t n = 0;
    int64_t record_elems = 0;  // c*h*w
    int dtype = 0;             // 0 u8, 1 f32
};

class ThreadPool {
  public:
    explicit ThreadPool(int n_threads) : stop_(false) {
        for (int i = 0; i < n_threads; ++i) {
            workers_.emplace_back([this] {
                for (;;) {
                    std::function<void()> job;
                    {
                        std::unique_lock<std::mutex> lk(mu_);
                        cv_.wait(lk, [this] {
                            return stop_ || !jobs_.empty();
                        });
                        if (stop_ && jobs_.empty()) return;
                        job = std::move(jobs_.front());
                        jobs_.pop();
                    }
                    job();
                }
            });
        }
    }

    ~ThreadPool() {
        {
            std::lock_guard<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& w : workers_) w.join();
    }

    void submit(std::function<void()> job) {
        {
            std::lock_guard<std::mutex> lk(mu_);
            jobs_.push(std::move(job));
        }
        cv_.notify_one();
    }

  private:
    std::vector<std::thread> workers_;
    std::queue<std::function<void()>> jobs_;
    std::mutex mu_;
    std::condition_variable cv_;
    bool stop_;
};

ThreadPool* pool() {
    static ThreadPool p(std::max(2u, std::thread::hardware_concurrency() / 2));
    return &p;
}

void convert_record(const Cache* c, int64_t idx, float* dst) {
    const uint8_t* rec;
    if (c->dtype == 0) {
        rec = c->base + static_cast<size_t>(idx) * c->record_elems;
        const uint8_t* s = rec;
        const float scale = 2.0f / 255.0f;
        for (int64_t j = 0; j < c->record_elems; ++j) {
            dst[j] = s[j] * scale - 1.0f;
        }
    } else {
        rec = c->base +
              static_cast<size_t>(idx) * c->record_elems * sizeof(float);
        std::memcpy(dst, rec, c->record_elems * sizeof(float));
    }
}

}  // namespace

extern "C" {

// Returns an opaque handle (heap pointer) or 0 on failure.
void* g2s_cache_open(const char* path, int64_t n, int64_t record_elems,
                     int dtype) {
    Cache* c = new Cache();
    c->fd = open(path, O_RDONLY);
    if (c->fd < 0) {
        delete c;
        return nullptr;
    }
    struct stat st;
    if (fstat(c->fd, &st) != 0) {
        close(c->fd);
        delete c;
        return nullptr;
    }
    size_t elem = dtype == 0 ? 1 : sizeof(float);
    size_t want = static_cast<size_t>(n) * record_elems * elem;
    if (static_cast<size_t>(st.st_size) < want) {
        close(c->fd);
        delete c;
        return nullptr;
    }
    c->file_size = st.st_size;
    void* m = mmap(nullptr, c->file_size, PROT_READ, MAP_PRIVATE, c->fd, 0);
    if (m == MAP_FAILED) {
        close(c->fd);
        delete c;
        return nullptr;
    }
    madvise(m, c->file_size, MADV_WILLNEED);
    c->base = static_cast<const uint8_t*>(m);
    c->n = n;
    c->record_elems = record_elems;
    c->dtype = dtype;
    return c;
}

void g2s_cache_close(void* handle) {
    Cache* c = static_cast<Cache*>(handle);
    if (!c) return;
    munmap(const_cast<uint8_t*>(c->base), c->file_size);
    close(c->fd);
    delete c;
}

// Assemble a batch: out[b] = convert(records[indices[b]]), parallel over b.
// Returns 0 on success.
int g2s_cache_get_batch(void* handle, const int64_t* indices,
                        int64_t batch, float* out) {
    Cache* c = static_cast<Cache*>(handle);
    if (!c) return 1;
    for (int64_t b = 0; b < batch; ++b) {
        if (indices[b] < 0 || indices[b] >= c->n) return 2;
    }
    std::atomic<int64_t> done(0);
    std::mutex mu;
    std::condition_variable cv;
    for (int64_t b = 0; b < batch; ++b) {
        pool()->submit([c, idx = indices[b], dst = out + b * c->record_elems,
                        &done, &cv, &mu, batch] {
            convert_record(c, idx, dst);
            if (done.fetch_add(1) + 1 == batch) {
                std::lock_guard<std::mutex> lk(mu);
                cv.notify_one();
            }
        });
    }
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [&] { return done.load() == batch; });
    return 0;
}

// Touch pages for upcoming records (read-ahead hint).
void g2s_cache_prefetch(void* handle, const int64_t* indices, int64_t count) {
    Cache* c = static_cast<Cache*>(handle);
    if (!c) return;
    size_t elem = c->dtype == 0 ? 1 : sizeof(float);
    size_t rec_bytes = c->record_elems * elem;
    for (int64_t i = 0; i < count; ++i) {
        if (indices[i] < 0 || indices[i] >= c->n) continue;
        madvise(const_cast<uint8_t*>(c->base + indices[i] * rec_bytes),
                rec_bytes, MADV_WILLNEED);
    }
}

int g2s_version() { return 1; }

}  // extern "C"
