// Native runtime of fpc_diffrend_tpu_torch: threaded data ingestion (the
// port's own copy of fpc_diffrend_tpu/runtime/csrc/fpcruntime.cpp).
//
// The reference pipeline's data path is Python/PIL, one file per optimizer
// step (reference fit.py:529-533). This library provides the host-side
// native equivalents used by the fit:
//
//   * fpc_load_take     — decode a whole take (many cameras x frames) of
//                         uncompressed grayscale TIFFs into one uint8
//                         tensor with a worker-thread pool, applying the
//                         reference's clip-to-[0,140] and vertical flip at
//                         ingest.
//   * fpc_parse_obj_vertices — mmap + hand-rolled float parsing of OBJ
//                         vertex blocks (the blendshape-stack ingest that
//                         the reference does line-by-line in Python,
//                         fit.py:205-216), threaded across files.
//   * fpc_seq_read_frames — bulk frame extraction from uncompressed
//                         NorPix .seq captures (the MATLAB ReadJpegSEQ
//                         equivalent for the monochrome path).
//
// Exposed as a plain C ABI for ctypes; no Python headers needed.
//
// Built with g++ at first use by fpc_diffrend_tpu_torch/runtime/native.py.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct MappedFile {
    const uint8_t* data = nullptr;
    size_t size = 0;
    int fd = -1;

    bool open(const char* path) {
        fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (fstat(fd, &st) != 0) { ::close(fd); return false; }
        size = static_cast<size_t>(st.st_size);
        data = static_cast<const uint8_t*>(
            mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
        if (data == MAP_FAILED) { data = nullptr; ::close(fd); return false; }
        return true;
    }
    ~MappedFile() {
        if (data) munmap(const_cast<uint8_t*>(data), size);
        if (fd >= 0) ::close(fd);
    }
};

// ---------------------------------------------------------------------------
// Minimal TIFF decoder: classic little/big-endian TIFF, uncompressed,
// grayscale 8/16-bit, strip-based (the capture-rig export format).
// ---------------------------------------------------------------------------

struct TiffInfo {
    uint32_t width = 0, height = 0, bits = 8;
    std::vector<uint64_t> strip_offsets;
    std::vector<uint64_t> strip_counts;
    uint32_t rows_per_strip = 0;
    bool ok = false;
};

static uint16_t rd16(const uint8_t* p, bool le) {
    return le ? (uint16_t)(p[0] | p[1] << 8) : (uint16_t)(p[1] | p[0] << 8);
}
static uint32_t rd32(const uint8_t* p, bool le) {
    return le ? (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
                    (uint32_t)p[3] << 24
              : (uint32_t)p[3] | (uint32_t)p[2] << 8 | (uint32_t)p[1] << 16 |
                    (uint32_t)p[0] << 24;
}

static TiffInfo parse_tiff(const uint8_t* d, size_t n) {
    TiffInfo t;
    if (n < 8) return t;
    bool le;
    if (d[0] == 'I' && d[1] == 'I') le = true;
    else if (d[0] == 'M' && d[1] == 'M') le = false;
    else return t;
    if (rd16(d + 2, le) != 42) return t;
    uint32_t ifd = rd32(d + 4, le);
    if (ifd + 2 > n) return t;
    uint16_t count = rd16(d + ifd, le);
    uint32_t compression = 1;
    for (uint16_t i = 0; i < count; i++) {
        const uint8_t* e = d + ifd + 2 + 12 * i;
        if (e + 12 > d + n) return t;
        uint16_t tag = rd16(e, le);
        uint16_t type = rd16(e + 2, le);
        uint32_t cnt = rd32(e + 4, le);
        auto value_at = [&](uint32_t idx) -> uint64_t {
            uint32_t esize = (type == 3) ? 2 : 4;   // SHORT or LONG
            const uint8_t* base;
            if (esize * cnt <= 4) base = e + 8;
            else base = d + rd32(e + 8, le);
            const uint8_t* p = base + esize * idx;
            if (p + esize > d + n) return 0;
            return (type == 3) ? rd16(p, le) : rd32(p, le);
        };
        switch (tag) {
            case 256: t.width = (uint32_t)value_at(0); break;
            case 257: t.height = (uint32_t)value_at(0); break;
            case 258: t.bits = (uint32_t)value_at(0); break;
            case 259: compression = (uint32_t)value_at(0); break;
            case 273:
                t.strip_offsets.resize(cnt);
                for (uint32_t k = 0; k < cnt; k++)
                    t.strip_offsets[k] = value_at(k);
                break;
            case 278: t.rows_per_strip = (uint32_t)value_at(0); break;
            case 279:
                t.strip_counts.resize(cnt);
                for (uint32_t k = 0; k < cnt; k++)
                    t.strip_counts[k] = value_at(k);
                break;
            default: break;
        }
    }
    t.ok = (compression == 1 && t.width && t.height &&
            !t.strip_offsets.empty() &&
            t.strip_offsets.size() == t.strip_counts.size() &&
            (t.bits == 8 || t.bits == 16));
    return t;
}

// Decode one grayscale TIFF into out (height*width uint8), clipping to
// clip_max and flipping vertically (reference fit.py:531-532 semantics).
static bool decode_tiff_u8(const char* path, uint8_t* out, uint32_t width,
                           uint32_t height, int clip_max, bool flip) {
    MappedFile f;
    if (!f.open(path)) return false;
    TiffInfo t = parse_tiff(f.data, f.size);
    if (!t.ok || t.width != width || t.height != height) return false;

    uint32_t row = 0;
    uint32_t rps = t.rows_per_strip ? t.rows_per_strip : t.height;
    for (size_t s = 0; s < t.strip_offsets.size() && row < height; s++) {
        const uint8_t* src = f.data + t.strip_offsets[s];
        uint64_t bytes = t.strip_counts[s];
        uint32_t rows_here = rps;
        if (row + rows_here > height) rows_here = height - row;
        uint32_t bpp = t.bits / 8;
        if ((uint64_t)rows_here * width * bpp > bytes) return false;
        for (uint32_t r = 0; r < rows_here; r++, row++) {
            uint32_t dst_row = flip ? (height - 1 - row) : row;
            uint8_t* dst = out + (size_t)dst_row * width;
            if (t.bits == 8) {
                const uint8_t* sp = src + (size_t)r * width;
                for (uint32_t c = 0; c < width; c++) {
                    uint8_t v = sp[c];
                    dst[c] = v > clip_max ? (uint8_t)clip_max : v;
                }
            } else {  // 16-bit: keep the high byte (capture rigs use 10-12b)
                const uint8_t* sp = src + (size_t)r * width * 2;
                for (uint32_t c = 0; c < width; c++) {
                    uint8_t v = sp[2 * c + 1];  // assumes little-endian file
                    dst[c] = v > clip_max ? (uint8_t)clip_max : v;
                }
            }
        }
    }
    return row == height;
}

static void parallel_for(size_t n, int n_threads, void (*body)(size_t, void*),
                         void* ctx) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<size_t> next(0);
    auto worker = [&]() {
        for (;;) {
            size_t i = next.fetch_add(1);
            if (i >= n) break;
            body(i, ctx);
        }
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads - 1; t++) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Probe a TIFF's dimensions. Returns 0 on success.
int fpc_tiff_probe(const char* path, uint32_t* width, uint32_t* height) {
    MappedFile f;
    if (!f.open(path)) return 1;
    TiffInfo t = parse_tiff(f.data, f.size);
    if (!t.ok) return 2;
    *width = t.width;
    *height = t.height;
    return 0;
}

// Decode n_files grayscale TIFFs (paths: array of C strings) into a
// contiguous (n_files, height, width) uint8 buffer, clipped + flipped.
// Returns the number of files that FAILED (0 = all good).
int fpc_load_take(const char** paths, int n_files, uint8_t* out,
                  uint32_t width, uint32_t height, int clip_max, int flip,
                  int n_threads) {
    struct Ctx {
        const char** paths;
        uint8_t* out;
        uint32_t w, h;
        int clip, flip;
        std::atomic<int> failures{0};
    } ctx{paths, out, width, height, clip_max, flip};
    parallel_for(
        (size_t)n_files, n_threads,
        [](size_t i, void* p) {
            Ctx* c = static_cast<Ctx*>(p);
            uint8_t* dst = c->out + i * (size_t)c->w * c->h;
            if (!decode_tiff_u8(c->paths[i], dst, c->w, c->h, c->clip,
                                c->flip != 0))
                c->failures.fetch_add(1);
        },
        &ctx);
    return ctx.failures.load();
}

// Parse the "v x y z" block of n_files OBJs into a (n_files, n_floats)
// float32 matrix (n_floats = 3 * n_vertices, known from the base mesh).
// Returns the number of files that FAILED.
int fpc_parse_obj_vertices(const char** paths, int n_files, float* out,
                           int64_t n_floats, int n_threads) {
    struct Ctx {
        const char** paths;
        float* out;
        int64_t n;
        std::atomic<int> failures{0};
    } ctx{paths, out, n_floats};
    parallel_for(
        (size_t)n_files, n_threads,
        [](size_t i, void* p) {
            Ctx* c = static_cast<Ctx*>(p);
            MappedFile f;
            if (!f.open(c->paths[i])) { c->failures++; return; }
            float* dst = c->out + i * c->n;
            int64_t k = 0;
            const char* s = reinterpret_cast<const char*>(f.data);
            const char* end = s + f.size;
            while (s < end && k < c->n) {
                // find "v " at line start
                if ((s == reinterpret_cast<const char*>(f.data) ||
                     s[-1] == '\n') && s + 1 < end && s[0] == 'v' &&
                    s[1] == ' ') {
                    char* next = nullptr;
                    s += 2;
                    for (int j = 0; j < 3 && k < c->n; j++) {
                        dst[k++] = strtof(s, &next);
                        s = next;
                    }
                }
                while (s < end && *s != '\n') s++;
                if (s < end) s++;
            }
            if (k != c->n) c->failures++;
        },
        &ctx);
    return ctx.failures.load();
}

// Bulk-read frames [first, first+count) of an uncompressed monochrome
// NorPix .seq into a (count, height, width) uint8 buffer. Returns 0 on
// success.
int fpc_seq_read_frames(const char* path, int first, int count, uint8_t* out,
                        uint32_t width, uint32_t height,
                        uint32_t true_image_size, int n_threads) {
    struct Ctx {
        const char* path;
        uint8_t* out;
        uint32_t w, h, tis;
        int first;
        std::atomic<int> failures{0};
    } ctx{path, out, width, height, true_image_size, first};
    parallel_for(
        (size_t)count, n_threads,
        [](size_t i, void* p) {
            Ctx* c = static_cast<Ctx*>(p);
            int fd = ::open(c->path, O_RDONLY);
            if (fd < 0) { c->failures++; return; }
            size_t nbytes = (size_t)c->w * c->h;
            off_t off = 8192 + (off_t)(c->first + i) * c->tis;
            ssize_t got = pread(fd, c->out + i * nbytes, nbytes, off);
            ::close(fd);
            if (got != (ssize_t)nbytes) c->failures++;
        },
        &ctx);
    return ctx.failures.load();
}

}  // extern "C"
