// Streaming numeric-text loader for the Gram-accumulation fit path.
//
// The reference package has no data loader (SURVEY.md §2: the user hands
// `fit` an in-memory array). For production streaming fits
// (utils/streaming.py :: GramAccumulator) the IO bottleneck is parsing
// large delimited text on the host. This loader does a single buffered
// pass with std::from_chars (locale-free, allocation-free) and a
// block-oriented C ABI, so Python pulls (block_rows, cols) float64
// blocks straight into preallocated NumPy buffers: measured up to
// ~300 MB/s vs numpy.loadtxt's ~60 on this box, with O(block) memory
// instead of materializing the whole file.
//
// C ABI (ctypes-friendly; see linearcorex_tpu/utils/native.py):
//   void*   lcx_csv_open(path, delim, skip_header) -> handle or NULL
//   int64   lcx_csv_cols(handle)
//   int64   lcx_csv_read_block(handle, max_rows, double* out)
//             -> rows written, 0 at EOF, -1 on parse error
//   void    lcx_csv_close(handle)

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <strings.h>
#include <string>
#include <vector>

namespace {

struct Reader {
    FILE* f = nullptr;
    char delim = ',';
    std::string carry;            // buffered input; pos = consumed prefix
    std::size_t pos = 0;
    std::vector<char> buf;
    int64_t cols = -1;            // fixed after the first data row
    bool eof = false;
    bool error = false;

    explicit Reader(std::size_t bufsize) : buf(bufsize) {}
};

// parse one line into out[0..cols); returns fields parsed (0 for a
// blank/whitespace-only line) or -1 on error. Blank delimiters (' ',
// '\t') separate fields by any RUN of blanks (no empty-field concept);
// other delimiters require exactly one delimiter between fields,
// optionally padded by blanks — an empty field is an error, matching
// the pure-Python fallback (utils/streaming.py :: iter_text_blocks).
int64_t parse_line(const char* s, const char* end, char delim,
                   double* out, int64_t max_fields) {
    const bool blank_delim = (delim == ' ' || delim == '\t');
    int64_t k = 0;
    const char* p = s;
    while (end > s && (end[-1] == '\r' || end[-1] == ' ' ||
                       end[-1] == '\t')) --end;   // trim trailing CR/blanks
    while (p < end) {
        while (p < end && (*p == ' ' || *p == '\t')) ++p;
        if (p >= end) break;
        if (k >= max_fields) return -1;
        // std::from_chars rejects a leading '+' (and 'inf'/'nan' on some
        // libstdc++); Python's float() accepts them — stay
        // fallback-identical
        bool neg = false;
        if (*p == '+') {
            ++p;
            // a sign after the consumed '+' ("+-5") must be an error:
            // std::from_chars would otherwise accept the '-', while the
            // Python fallback (float("+-5")) raises — stay identical
            if (p >= end || *p == '+' || *p == '-') return -1;
        } else if (*p == '-') {
            neg = true;
        }
        double v;
        auto res = std::from_chars(p, end, v);
        if (res.ec != std::errc()) {
            const char* q0 = p + (neg ? 1 : 0);
            auto is = [&](const char* lit, int len) {
                return (end - q0) >= len && strncasecmp(q0, lit, len) == 0;
            };
            if (is("nan", 3)) {
                v = std::nan("");
                res.ptr = q0 + 3;
            } else if (is("infinity", 8)) {
                v = neg ? -HUGE_VAL : HUGE_VAL;
                res.ptr = q0 + 8;
            } else if (is("inf", 3)) {
                v = neg ? -HUGE_VAL : HUGE_VAL;
                res.ptr = q0 + 3;
            } else {
                return -1;
            }
        }
        out[k++] = v;
        p = res.ptr;
        const char* q = p;
        while (q < end && (*q == ' ' || *q == '\t')) ++q;
        if (blank_delim) {
            p = q;                       // a run of blanks IS the delimiter
            continue;
        }
        if (q < end) {
            if (*q != delim) return -1;
            p = q + 1;
            // a delimiter with nothing after it is a trailing EMPTY field
            // (the fallback rejects it; silently dropping it would be
            // data misalignment)
            const char* rest = p;
            while (rest < end && (*rest == ' ' || *rest == '\t')) ++rest;
            if (rest >= end) return -1;
        } else {
            p = q;
        }
    }
    return k;
}

// pull the next full line (without trailing newline) into `line`;
// returns false at clean EOF with no pending data. An offset cursor
// (pos) instead of per-line erase keeps this O(bytes) overall — a
// front-erase per row is a memmove of the whole remaining buffer and
// made the first version SLOWER than numpy.loadtxt (41 vs 66 MB/s).
bool next_line(Reader* r, std::string& line) {
    for (;;) {
        std::size_t nl = r->carry.find('\n', r->pos);
        if (nl != std::string::npos) {
            line.assign(r->carry, r->pos, nl - r->pos);
            r->pos = nl + 1;
            return true;
        }
        if (r->eof) {
            if (r->pos >= r->carry.size()) return false;
            line.assign(r->carry, r->pos, std::string::npos);
            r->pos = r->carry.size();
            return true;
        }
        // compact the consumed prefix once per refill, then append
        r->carry.erase(0, r->pos);
        r->pos = 0;
        std::size_t got = std::fread(r->buf.data(), 1, r->buf.size(), r->f);
        if (got == 0) {
            r->eof = true;
            continue;
        }
        r->carry.append(r->buf.data(), got);
    }
}

}  // namespace

extern "C" {

void* lcx_csv_open(const char* path, char delim, int64_t skip_header) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    auto* r = new Reader(1 << 20);
    r->f = f;
    r->delim = delim ? delim : ',';
    std::string line;
    for (int64_t i = 0; i < skip_header; ++i) {
        if (!next_line(r, line)) break;
    }
    return r;
}

int64_t lcx_csv_cols(void* handle) {
    auto* r = static_cast<Reader*>(handle);
    if (r->cols >= 0) return r->cols;
    // peek the first DATA line to count fields (skipping blank lines),
    // then put it back
    std::string line;
    int64_t k = 0;
    for (;;) {
        if (!next_line(r, line)) return 0;
        std::vector<double> tmp(2 + std::count(line.begin(), line.end(),
                                               r->delim)
                                + static_cast<int64_t>(line.size()) / 2);
        k = parse_line(line.data(), line.data() + line.size(),
                       r->delim, tmp.data(),
                       static_cast<int64_t>(tmp.size()));
        if (k != 0) break;               // data line or error
    }
    if (k < 0) {
        r->error = true;
        return -1;
    }
    r->cols = k;
    // push the consumed line back in front of the unconsumed carry
    line.push_back('\n');
    r->carry.replace(0, r->pos, line);
    r->pos = 0;
    return r->cols;
}

int64_t lcx_csv_read_block(void* handle, int64_t max_rows, double* out) {
    auto* r = static_cast<Reader*>(handle);
    if (r->error) return -1;
    if (r->cols < 0 && lcx_csv_cols(handle) <= 0) return -1;
    int64_t rows = 0;
    std::string tail;
    while (rows < max_rows) {
        // fast path: parse complete lines directly out of the carry
        // buffer (zero copy); fall back to next_line for buffer refills
        std::size_t nl = r->carry.find('\n', r->pos);
        const char *s, *e;
        if (nl != std::string::npos) {
            s = r->carry.data() + r->pos;
            e = r->carry.data() + nl;
            r->pos = nl + 1;
        } else {
            if (!next_line(r, tail)) break;
            s = tail.data();
            e = s + tail.size();
        }
        if (s == e) continue;
        int64_t k = parse_line(s, e, r->delim, out + rows * r->cols,
                               r->cols);
        if (k == 0) continue;            // blank/whitespace-only line
        if (k != r->cols) {
            r->error = true;
            return -1;
        }
        ++rows;
    }
    return rows;
}

void lcx_csv_close(void* handle) {
    auto* r = static_cast<Reader*>(handle);
    if (r) {
        if (r->f) std::fclose(r->f);
        delete r;
    }
}

}  // extern "C"
