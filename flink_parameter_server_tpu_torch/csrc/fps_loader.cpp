// fps_loader — native host-side rating-stream loader/batcher.
//
// Reference parity: the reference delegates ingestion to Flink's JVM
// runtime (DataStream sources — SURVEY.md §1 L1). This framework's
// ingestion edge is native C++: mmap'd zero-copy parsing of MovieLens
// -format rating files (tab / '::' / csv) and a background-thread
// batcher with a bounded ring buffer, so batch assembly runs off the
// Python GIL while the TPU consumes the previous microbatch.
//
// C ABI (ctypes-friendly); see data/native_loader.py for the Python side.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <random>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Mapped {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;
    bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
    Mapped m;
    m.fd = ::open(path, O_RDONLY);
    if (m.fd < 0) return m;
    struct stat st;
    if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
        ::close(m.fd);
        m.fd = -1;
        return m;
    }
    void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
    if (p == MAP_FAILED) {
        ::close(m.fd);
        m.fd = -1;
        return m;
    }
    m.data = static_cast<const char*>(p);
    m.size = st.st_size;
    return m;
}

void unmap(Mapped& m) {
    if (m.data) munmap(const_cast<char*>(m.data), m.size);
    if (m.fd >= 0) ::close(m.fd);
    m.data = nullptr;
    m.fd = -1;
}

// Parse one rating line: "<user><sep><item><sep><rating>..." where <sep>
// is tab, comma, or "::".  Returns false on malformed/header lines.
// The line is copied into a NUL-terminated stack buffer first: strto*
// would otherwise scan past `end`, and an mmap'd file whose size is an
// exact multiple of the page size has no readable byte after the last
// mapped one (SIGBUS).
bool parse_line(const char* p, const char* end, int64_t* u, int64_t* i,
                float* r) {
    char buf[256];
    size_t len = (size_t)(end - p);
    if (len == 0) return false;
    if (len >= sizeof(buf)) len = sizeof(buf) - 1;
    memcpy(buf, p, len);
    buf[len] = '\0';
    const char* b = buf;
    const char* bend = buf + len;
    auto skip_sep = [&](const char*& q) {
        while (q < bend && (*q == ':' || *q == ',' || *q == '\t' || *q == ' '))
            ++q;
    };
    char* next = nullptr;
    long long uu = strtoll(b, &next, 10);
    if (next == b) return false;
    const char* q = next;
    skip_sep(q);
    long long ii = strtoll(q, &next, 10);
    if (next == q) return false;
    q = next;
    skip_sep(q);
    float rr = strtof(q, &next);
    if (next == q) return false;
    *u = uu;
    *i = ii;
    *r = rr;
    return true;
}

struct ParsedFile {
    std::vector<int64_t> users, items;
    std::vector<float> ratings;
};

bool parse_file(const char* path, ParsedFile& out, int64_t max_rows) {
    Mapped m = map_file(path);
    if (!m.ok()) return false;
    const char* p = m.data;
    const char* end = m.data + m.size;
    while (p < end && (max_rows < 0 ||
                       (int64_t)out.users.size() < max_rows)) {
        const char* line_end = static_cast<const char*>(
            memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        int64_t u, i;
        float r;
        if (parse_line(p, line_end, &u, &i, &r)) {
            out.users.push_back(u);
            out.items.push_back(i);
            out.ratings.push_back(r);
        }
        p = line_end + 1;
    }
    unmap(m);
    return true;
}

// ---- streaming batcher -------------------------------------------------

struct Batch {
    std::vector<int64_t> u, i;
    std::vector<float> r;
    int64_t n = 0;
};

struct Stream {
    ParsedFile file;
    int64_t batch_size = 0;
    int64_t epochs = 1;
    uint64_t seed = 0;
    bool shuffle = false;

    std::thread worker;
    std::mutex mu;
    std::condition_variable cv_put, cv_get;
    std::vector<Batch> ring;
    size_t head = 0, tail = 0, count = 0;
    bool done = false, stop = false;

    void run() {
        std::mt19937_64 rng(seed);
        const int64_t n = (int64_t)file.users.size();
        std::vector<int64_t> order(n);
        for (int64_t k = 0; k < n; ++k) order[k] = k;
        for (int64_t e = 0; e < epochs; ++e) {
            if (shuffle) std::shuffle(order.begin(), order.end(), rng);
            for (int64_t s = 0; s < n; s += batch_size) {
                Batch b;
                b.n = std::min(batch_size, n - s);
                b.u.resize(b.n);
                b.i.resize(b.n);
                b.r.resize(b.n);
                for (int64_t k = 0; k < b.n; ++k) {
                    int64_t idx = order[s + k];
                    b.u[k] = file.users[idx];
                    b.i[k] = file.items[idx];
                    b.r[k] = file.ratings[idx];
                }
                std::unique_lock<std::mutex> lk(mu);
                cv_put.wait(lk, [&] { return count < ring.size() || stop; });
                if (stop) return;
                ring[tail] = std::move(b);
                tail = (tail + 1) % ring.size();
                ++count;
                cv_get.notify_one();
            }
        }
        std::lock_guard<std::mutex> lk(mu);
        done = true;
        cv_get.notify_all();
    }
};

}  // namespace

extern "C" {

// Parse the whole file; returns a handle (heap ParsedFile*) or null.
void* fps_parse(const char* path, int64_t max_rows) {
    auto* f = new ParsedFile();
    if (!parse_file(path, *f, max_rows)) {
        delete f;
        return nullptr;
    }
    return f;
}

int64_t fps_num_rows(void* handle) {
    return (int64_t) static_cast<ParsedFile*>(handle)->users.size();
}

// Copy parsed columns into caller-provided buffers (len >= num_rows).
void fps_columns(void* handle, int64_t* users, int64_t* items,
                 float* ratings) {
    auto* f = static_cast<ParsedFile*>(handle);
    memcpy(users, f->users.data(), f->users.size() * sizeof(int64_t));
    memcpy(items, f->items.data(), f->items.size() * sizeof(int64_t));
    memcpy(ratings, f->ratings.data(), f->ratings.size() * sizeof(float));
}

void fps_free(void* handle) { delete static_cast<ParsedFile*>(handle); }

// Open a background-thread batch stream over a parsed file.
void* fps_stream_open(const char* path, int64_t batch_size, int64_t epochs,
                      int shuffle, uint64_t seed, int64_t ring_capacity) {
    auto* s = new Stream();
    if (!parse_file(path, s->file, -1) || batch_size <= 0) {
        delete s;
        return nullptr;
    }
    s->batch_size = batch_size;
    s->epochs = epochs;
    s->shuffle = shuffle != 0;
    s->seed = seed;
    s->ring.resize(ring_capacity > 0 ? ring_capacity : 4);
    s->worker = std::thread([s] { s->run(); });
    return s;
}

// Fetch the next batch into caller buffers (sized >= batch_size).
// Returns rows copied; 0 = end of stream.
int64_t fps_stream_next(void* handle, int64_t* u, int64_t* i, float* r) {
    auto* s = static_cast<Stream*>(handle);
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_get.wait(lk, [&] { return s->count > 0 || s->done; });
    if (s->count == 0) return 0;
    Batch b = std::move(s->ring[s->head]);
    s->head = (s->head + 1) % s->ring.size();
    --s->count;
    s->cv_put.notify_one();
    lk.unlock();
    memcpy(u, b.u.data(), b.n * sizeof(int64_t));
    memcpy(i, b.i.data(), b.n * sizeof(int64_t));
    memcpy(r, b.r.data(), b.n * sizeof(float));
    return b.n;
}

void fps_stream_close(void* handle) {
    auto* s = static_cast<Stream*>(handle);
    {
        std::lock_guard<std::mutex> lk(s->mu);
        s->stop = true;
        s->cv_put.notify_all();
    }
    if (s->worker.joinable()) s->worker.join();
    delete s;
}

}  // extern "C"
