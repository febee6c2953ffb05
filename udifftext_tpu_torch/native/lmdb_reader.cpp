// Native read-only LMDB main-DB reader (mmap + B+tree walk).
//
// The reference consumes its STR benchmark LMDBs through the C liblmdb
// (src/parseq/strhub/data/dataset.py:31-137). This is the native
// equivalent of that hot read path: same on-disk format subset as the pure
// Python udifftext_tpu_torch/data/lmdb.py reader (64-bit little-endian layout,
// main DB only, no DUPSORT / nested DBs), exposed through a minimal C ABI
// consumed via ctypes (udifftext_tpu_torch/data/lmdb_native.py). get() returns
// pointers INTO the read-only mapping — zero-copy; valid until close.
//
// Build: g++ -O2 -shared -fPIC -o ulmdb.so lmdb_reader.cpp (no deps).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xBEEFC0DE;
constexpr uint32_t kVersion = 1;

constexpr uint16_t P_BRANCH = 0x01;
constexpr uint16_t P_LEAF = 0x02;
constexpr uint16_t P_META = 0x08;

constexpr uint16_t F_BIGDATA = 0x01;

constexpr size_t PAGEHDRSZ = 16;
constexpr size_t NODEHDRSZ = 8;
constexpr uint64_t INVALID_PGNO = ~0ULL;

// struct offsets within a meta page (after the 16-byte page header):
//   MDB_meta: magic u32, version u32, address u64, mapsize u64   (24 bytes)
//   MDB_db x2: md_pad u32, md_flags u16, md_depth u16,
//              branch/leaf/overflow/entries/root u64 x5          (48 bytes)
//   last_pg u64, txnid u64
constexpr size_t META_HEAD = 24;
constexpr size_t DB_SIZE = 48;

inline uint16_t rd16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }
inline uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }

// unsigned lexicographic compare with prefix rule — matches Python bytes
// ordering and liblmdb's default mdb_cmp_memn
inline int key_cmp(const uint8_t* a, size_t alen, const uint8_t* b, size_t blen) {
    size_t n = alen < blen ? alen : blen;
    int c = n ? std::memcmp(a, b, n) : 0;
    if (c) return c;
    return alen < blen ? -1 : (alen > blen ? 1 : 0);
}

struct Meta {
    bool ok = false;
    uint32_t psize = 0;
    uint64_t entries = 0;
    uint64_t root = INVALID_PGNO;
    uint64_t last_pg = 0;
    uint64_t txnid = 0;
};

struct Reader {
    int fd = -1;
    const uint8_t* map = nullptr;
    size_t size = 0;
    uint32_t psize = 0;
    uint64_t entries = 0;
    uint64_t root = INVALID_PGNO;

    const uint8_t* page(uint64_t pgno) const { return map + pgno * psize; }
    bool page_ok(uint64_t pgno) const {
        return pgno != INVALID_PGNO && (pgno + 1) * (uint64_t)psize <= size;
    }
};

Meta read_meta(const Reader& r, size_t off) {
    Meta m;
    if (off + PAGEHDRSZ + META_HEAD + 2 * DB_SIZE + 16 > r.size) return m;
    const uint8_t* p = r.map + off;
    uint16_t flags = rd16(p + 10);
    if (!(flags & P_META)) return m;
    if (rd32(p + PAGEHDRSZ) != kMagic || rd32(p + PAGEHDRSZ + 4) != kVersion)
        return m;
    const uint8_t* dbs = p + PAGEHDRSZ + META_HEAD;
    uint32_t psize = rd32(dbs);  // FREE_DBI md_pad carries mm_psize
    const uint8_t* main_db = dbs + DB_SIZE;
    m.ok = true;
    m.psize = psize ? psize : 4096;
    m.entries = rd64(main_db + 32);
    m.root = rd64(main_db + 40);
    m.last_pg = rd64(dbs + 2 * DB_SIZE);
    m.txnid = rd64(dbs + 2 * DB_SIZE + 8);
    return m;
}

// node idx on a page: returns node offset within the file
inline const uint8_t* node_at(const Reader& r, const uint8_t* pg, unsigned idx) {
    uint16_t ptr = rd16(pg + PAGEHDRSZ + 2 * idx);
    return pg + ptr;
}

inline unsigned num_keys(const uint8_t* pg) {
    uint16_t lower = rd16(pg + 12);
    return (lower - PAGEHDRSZ) >> 1;
}

}  // namespace

extern "C" {

void* ulmdb_open(const char* path, char* err, size_t errlen) {
    auto fail = [&](const std::string& msg) -> void* {
        if (err && errlen) std::snprintf(err, errlen, "%s", msg.c_str());
        return nullptr;
    };
    // accept a directory (data.mdb inside, like lmdb.open) or a file
    std::string p(path);
    struct stat st;
    if (stat(p.c_str(), &st) == 0 && S_ISDIR(st.st_mode)) p += "/data.mdb";
    int fd = open(p.c_str(), O_RDONLY);
    if (fd < 0) return fail(p + ": cannot open");
    off_t sz = lseek(fd, 0, SEEK_END);
    if (sz <= 0) { close(fd); return fail(p + ": empty file"); }
    void* map = mmap(nullptr, (size_t)sz, PROT_READ, MAP_SHARED, fd, 0);
    if (map == MAP_FAILED) { close(fd); return fail(p + ": mmap failed"); }

    auto* r = new Reader();
    r->fd = fd;
    r->map = (const uint8_t*)map;
    r->size = (size_t)sz;

    // pick the live meta: meta 0 at offset 0; meta 1 at psize (probe common
    // OS page sizes when meta 0 is unreadable) — mirrors LMDBReader._pick_meta
    Meta m0 = read_meta(*r, 0);
    Meta best;
    if (m0.ok) {
        best = m0;
        Meta m1 = read_meta(*r, m0.psize);
        if (m1.ok && m1.txnid > best.txnid) best = m1;
        if (!m1.ok && m0.last_pg > 1) {
            munmap((void*)r->map, r->size); close(fd); delete r;
            return fail(p + ": meta page 1 invalid at declared psize");
        }
    } else {
        for (uint32_t ps : {4096u, 8192u, 16384u, 32768u, 65536u}) {
            Meta m1 = read_meta(*r, ps);
            if (m1.ok) { best = m1; break; }
        }
        if (!best.ok) {
            munmap((void*)r->map, r->size); close(fd); delete r;
            return fail(p + ": not an LMDB data file");
        }
    }
    r->psize = best.psize;
    r->entries = best.entries;
    r->root = best.root;
    return r;
}

void ulmdb_close(void* h) {
    auto* r = (Reader*)h;
    if (!r) return;
    munmap((void*)r->map, r->size);
    close(r->fd);
    delete r;
}

uint64_t ulmdb_entries(void* h) { return ((Reader*)h)->entries; }

// Point lookup. Returns a pointer into the mapping (valid until close), or
// nullptr when absent / on a malformed page (rc: 0 ok, 1 absent, 2 corrupt).
const uint8_t* ulmdb_get(void* h, const uint8_t* key, size_t klen,
                         uint64_t* vlen, int* rc) {
    auto* r = (Reader*)h;
    if (rc) *rc = 1;
    uint64_t pgno = r->root;
    if (pgno == INVALID_PGNO) return nullptr;
    while (true) {
        if (!r->page_ok(pgno)) { if (rc) *rc = 2; return nullptr; }
        const uint8_t* pg = r->page(pgno);
        uint16_t flags = rd16(pg + 10);
        unsigned n = num_keys(pg);
        if (flags & P_BRANCH) {
            // binary search: last child whose key <= target (node 0 = -inf)
            unsigned lo = 1, hi = n;  // invariant: nodes [1, lo) have key <= target
            while (lo < hi) {
                unsigned mid = (lo + hi) / 2;
                const uint8_t* nd = node_at(*r, pg, mid);
                uint16_t ksize = rd16(nd + 6);
                if (key_cmp(nd + NODEHDRSZ, ksize, key, klen) <= 0)
                    lo = mid + 1;
                else
                    hi = mid;
            }
            const uint8_t* nd = node_at(*r, pg, lo - 1);
            pgno = (uint64_t)rd16(nd) | ((uint64_t)rd16(nd + 2) << 16) |
                   ((uint64_t)rd16(nd + 4) << 32);
        } else if (flags & P_LEAF) {
            unsigned lo = 0, hi = n;
            while (lo < hi) {
                unsigned mid = (lo + hi) / 2;
                const uint8_t* nd = node_at(*r, pg, mid);
                uint16_t ksize = rd16(nd + 6);
                int c = key_cmp(nd + NODEHDRSZ, ksize, key, klen);
                if (c < 0) lo = mid + 1;
                else hi = mid;
            }
            if (lo >= n) return nullptr;
            const uint8_t* nd = node_at(*r, pg, lo);
            uint16_t ksize = rd16(nd + 6);
            if (key_cmp(nd + NODEHDRSZ, ksize, key, klen) != 0) return nullptr;
            uint16_t nflags = rd16(nd + 4);
            uint64_t dsize = (uint64_t)rd16(nd) | ((uint64_t)rd16(nd + 2) << 16);
            const uint8_t* data = nd + NODEHDRSZ + ksize;
            if (nflags & F_BIGDATA) {
                uint64_t ov = rd64(data);
                if (!r->page_ok(ov)) { if (rc) *rc = 2; return nullptr; }
                data = r->page(ov) + PAGEHDRSZ;
            }
            if ((size_t)(data - r->map) + dsize > r->size) {
                if (rc) *rc = 2;
                return nullptr;
            }
            if (vlen) *vlen = dsize;
            if (rc) *rc = 0;
            return data;
        } else {
            if (rc) *rc = 2;
            return nullptr;
        }
    }
}

// In-order cursor over the main DB (matches LMDBReader.items()).
struct Cursor {
    Reader* r;
    // stack of (pgno, next child idx) for branches; leaf handled flat
    std::vector<std::pair<uint64_t, unsigned>> stack;
    uint64_t leaf_pg = INVALID_PGNO;
    unsigned leaf_idx = 0;
    bool corrupt = false;
};

void* ulmdb_cursor(void* h) {
    auto* r = (Reader*)h;
    auto* c = new Cursor();
    c->r = r;
    if (r->root != INVALID_PGNO) c->stack.push_back({r->root, 0});
    return c;
}

int ulmdb_cursor_next(void* cur, const uint8_t** k, uint64_t* klen,
                      const uint8_t** v, uint64_t* vlen) {
    auto* c = (Cursor*)cur;
    Reader* r = c->r;
    while (true) {
        if (c->leaf_pg != INVALID_PGNO) {
            const uint8_t* pg = r->page(c->leaf_pg);
            unsigned n = num_keys(pg);
            if (c->leaf_idx < n) {
                const uint8_t* nd = node_at(*r, pg, c->leaf_idx++);
                uint16_t ksize = rd16(nd + 6);
                uint16_t nflags = rd16(nd + 4);
                uint64_t dsize =
                    (uint64_t)rd16(nd) | ((uint64_t)rd16(nd + 2) << 16);
                const uint8_t* data = nd + NODEHDRSZ + ksize;
                if (nflags & F_BIGDATA) {
                    uint64_t ov = rd64(data);
                    if (!r->page_ok(ov)) { c->corrupt = true; return -1; }
                    data = r->page(ov) + PAGEHDRSZ;
                }
                *k = nd + NODEHDRSZ;
                *klen = ksize;
                *v = data;
                *vlen = dsize;
                return 1;
            }
            c->leaf_pg = INVALID_PGNO;
            c->leaf_idx = 0;
        }
        if (c->stack.empty()) return 0;
        auto [pgno, idx] = c->stack.back();
        c->stack.pop_back();
        if (!r->page_ok(pgno)) { c->corrupt = true; return -1; }
        const uint8_t* pg = r->page(pgno);
        uint16_t flags = rd16(pg + 10);
        unsigned n = num_keys(pg);
        if (flags & P_LEAF) {
            c->leaf_pg = pgno;
            c->leaf_idx = 0;
        } else if (flags & P_BRANCH) {
            if (idx < n) {
                c->stack.push_back({pgno, idx + 1});
                const uint8_t* nd = node_at(*r, pg, idx);
                uint64_t child = (uint64_t)rd16(nd) |
                                 ((uint64_t)rd16(nd + 2) << 16) |
                                 ((uint64_t)rd16(nd + 4) << 32);
                c->stack.push_back({child, 0});
            }
        } else {
            c->corrupt = true;
            return -1;
        }
    }
}

void ulmdb_cursor_close(void* cur) { delete (Cursor*)cur; }

}  // extern "C"
