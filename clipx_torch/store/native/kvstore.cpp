// clipx host-native key-value store.
//
// LMDB-equivalent storage for the framework (the reference links liblmdb
// via py-lmdb: reference:build-index.py:22-24, reference:query-index.py:25-27;
// neither the wheel nor the C library exists in this environment, so the
// store is implemented here from scratch). Same observable model:
//
//   * an environment is a directory holding named sub-databases
//   * byte-string keys and values
//   * read and write transactions; write transactions are atomic and
//     durable (buffered ops -> WAL append + fsync -> in-memory apply)
//   * cursors iterate a database in lexicographic byte order — the
//     property the indexer relies on for stable id assignment
//     (reference:build-index.py:75-88)
//   * a single writer at a time, enforced across processes with flock(2)
//     on <env>/LOCK (the reference documents multi-writer corruption as a
//     known issue; we prevent it instead)
//
// Design: a one-level LSM. The bulk of the data lives in an immutable
// *sorted segment* file that is mmap(2)-ed and binary-searched — like
// LMDB's mmap, it costs no resident RAM beyond the page cache and no
// open-time parse. Recent writes live in a write-ahead log replayed
// into small in-memory overlay maps at open. When the overlay grows
// past a bound (CLIPX_KV_MEMTABLE_MB, default 256), or at close after a
// large ingest, segment + overlay are merged into a new segment
// generation and the WAL is rotated, so neither RSS nor open latency
// scales with total corpus size (the round-1 whole-DB-in-RAM design hit
// ~2 GB RSS and a full-log parse per CLI start at 1M images).
//
// Files inside <env>/:
//   LOCK            cross-process flock
//   MANIFEST        "CXMF001 <gen>\n" — current generation (atomic rename)
//   seg-<G>.cxs     sorted segment of generation G (absent for G=0)
//   wal-<G>.cxkv    write-ahead log of generation G (gen 0 uses the
//                   legacy name data.cxkv, so round-1 envs open as-is)
//
// Readers and the writer share one env mutex taken per *operation* (not
// per transaction), so the reference's pattern of a long-lived read
// cursor over fn_db interleaved with write transactions on idx_db
// (reference:build-index.py:68-88) cannot deadlock. Cursors hold only
// their current key (copied), so segment swaps under them are safe.
// Cross-process coherence: every commit (and refresh()) re-reads the
// MANIFEST; a generation bump by another process triggers a cheap
// reload (mmap new segment + replay the small new WAL).
//
// Exposed as a C ABI for ctypes (clipx_torch/store/kv.py).

#include <dirent.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <fcntl.h>
#include <unistd.h>

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <vector>

namespace {

constexpr char kMagic[8] = {'C', 'X', 'K', 'V', '0', '0', '1', '\n'};
constexpr char kSegMagic[8] = {'C', 'X', 'S', 'G', '0', '0', '1', '\n'};
constexpr uint8_t kOpPut = 1;
constexpr uint8_t kOpDel = 2;
// close-time compaction threshold: fold the WAL into the segment after
// a bulk ingest so the next open is O(overlay), not O(corpus)
constexpr uint64_t kCloseCompactWalRecords = 1024;

using Map = std::map<std::string, std::string>;

uint64_t memtable_cap_bytes() {
    const char* s = ::getenv("CLIPX_KV_MEMTABLE_MB");
    long mb = s ? ::atol(s) : 0;
    if (mb <= 0) mb = 256;
    return static_cast<uint64_t>(mb) << 20;
}

// -- sorted segment (immutable, mmap-ed) -----------------------------------
//
// layout: kSegMagic, u32 n_dbs, then per db {u32 name_len, name bytes,
// u64 count, u64 index_off}; at index_off: count u64 absolute record
// offsets; each record: u32 klen, u32 vlen, key, val. All integers
// little-endian, read via memcpy (no alignment assumptions).

struct SegEntry {
    const char* key;
    uint32_t klen;
    const char* val;
    uint32_t vlen;
};

struct SegDb {
    uint64_t count = 0;
    const char* index = nullptr;  // count u64 offsets
};

struct Segment {
    char* base = nullptr;
    size_t size = 0;
    std::map<std::string, SegDb> dbs;

    ~Segment() {
        if (base) ::munmap(base, size);
    }

    bool load(const std::string& path) {
        int fd = ::open(path.c_str(), O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (::fstat(fd, &st) != 0 || st.st_size < 12) {
            ::close(fd);
            return false;
        }
        size = static_cast<size_t>(st.st_size);
        base = static_cast<char*>(
            ::mmap(nullptr, size, PROT_READ, MAP_SHARED, fd, 0));
        ::close(fd);
        if (base == MAP_FAILED) {
            base = nullptr;
            return false;
        }
        if (::memcmp(base, kSegMagic, 8) != 0) return false;
        uint32_t n_dbs;
        size_t pos = 8;
        if (pos + 4 > size) return false;
        ::memcpy(&n_dbs, base + pos, 4);
        pos += 4;
        for (uint32_t i = 0; i < n_dbs; ++i) {
            uint32_t nl;
            if (pos + 4 > size) return false;
            ::memcpy(&nl, base + pos, 4);
            pos += 4;
            if (pos + nl + 16 > size) return false;
            std::string name(base + pos, nl);
            pos += nl;
            SegDb d;
            uint64_t index_off;
            ::memcpy(&d.count, base + pos, 8);
            ::memcpy(&index_off, base + pos + 8, 8);
            pos += 16;
            // overflow-safe bounds: count is untrusted on-disk data
            if (index_off > size || d.count > (size - index_off) / 8) {
                return false;
            }
            d.index = base + index_off;
            // validate the offsets array up front (touches only the
            // 8-byte-per-record index region, not the records): every
            // record header must lie inside the file, monotonically —
            // a truncated or bit-rotted segment fails open instead of
            // walking memcpy past the mmap
            uint64_t prev = 0;
            for (uint64_t i = 0; i < d.count; ++i) {
                uint64_t off;
                ::memcpy(&off, d.index + 8 * i, 8);
                // NB: `off > size - 8`, not `off + 8 > size` — the
                // latter wraps for corrupt offsets near UINT64_MAX and
                // would pass the very check this loop exists for
                // (size >= 12 was verified at the top of load)
                if (off < 12 || off > size - 8 || off < prev) return false;
                prev = off;
            }
            dbs.emplace(std::move(name), d);
        }
        return true;
    }
};

SegEntry seg_entry(const Segment& s, const SegDb& d, uint64_t i) {
    uint64_t off;
    ::memcpy(&off, d.index + 8 * i, 8);
    SegEntry e;
    ::memcpy(&e.klen, s.base + off, 4);
    ::memcpy(&e.vlen, s.base + off + 4, 4);
    // lengths are untrusted: clamp a record extending past the mmap to
    // an empty entry rather than reading out of bounds (offsets were
    // range-checked at load; only klen/vlen can still lie)
    if (e.klen > s.size || e.vlen > s.size ||
        off + 8 + e.klen + e.vlen > s.size) {
        e.klen = 0;
        e.vlen = 0;
    }
    e.key = s.base + off + 8;
    e.val = e.key + e.klen;
    return e;
}

int seg_key_cmp(const SegEntry& e, const std::string& key) {
    size_t n = e.klen < key.size() ? e.klen : key.size();
    int c = ::memcmp(e.key, key.data(), n);
    if (c != 0) return c;
    if (e.klen == key.size()) return 0;
    return e.klen < key.size() ? -1 : 1;
}

// first index whose key is >= key (count if none)
uint64_t seg_lower_bound(const Segment& s, const SegDb& d,
                         const std::string& key) {
    uint64_t lo = 0, hi = d.count;
    while (lo < hi) {
        uint64_t mid = lo + (hi - lo) / 2;
        if (seg_key_cmp(seg_entry(s, d, mid), key) < 0) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

bool seg_find(const Segment& s, const SegDb& d, const std::string& key,
              SegEntry* out) {
    uint64_t i = seg_lower_bound(s, d, key);
    if (i >= d.count) return false;
    SegEntry e = seg_entry(s, d, i);
    if (seg_key_cmp(e, key) != 0) return false;
    *out = e;
    return true;
}

// -- environment ------------------------------------------------------------

struct DbState {
    Map puts;                    // overlay inserts/updates
    std::set<std::string> dels;  // tombstones masking segment keys
    const SegDb* seg = nullptr;  // borrowed from Env::segment
    uint64_t live = 0;           // visible key count
};

struct Env {
    std::string dir;
    // Serializes this process's flock windows. flock(2) locks belong to
    // the open file description, not the thread: a second LOCK_EX on
    // the already-held fd succeeds as a no-op and the first LOCK_UN
    // releases it for everyone — two threads of one process would both
    // "hold" the cross-process writer lock while another process
    // legitimately acquires it. Always acquired BEFORE lock_fd's flock
    // (and before mu, where both are taken).
    std::mutex wlock_mu;
    std::mutex mu;                      // protects everything below
    std::map<std::string, int> db_ids;  // name -> id (process-local)
    std::vector<std::string> db_names;
    std::vector<DbState> dbs;
    std::shared_ptr<Segment> segment;   // may be null (gen with no segment)
    uint64_t gen = 0;
    int log_fd = -1;
    int lock_fd = -1;
    uint64_t wal_records = 0;   // records in the current WAL file
    uint64_t log_offset = 0;    // bytes of the WAL applied to memory
    uint64_t overlay_bytes = 0; // approximate RAM held by puts/dels
    uint64_t memtable_cap = 0;
    std::string error;
    // set when in-memory state could not be restored after a partial
    // compaction failure: disk is consistent, this handle is not —
    // mutations are refused until the env is reopened
    bool failed = false;
};

std::string wal_path(const Env* env, uint64_t gen) {
    if (gen == 0) return env->dir + "/data.cxkv";  // legacy round-1 name
    return env->dir + "/wal-" + std::to_string(gen) + ".cxkv";
}

std::string seg_path(const Env* env, uint64_t gen) {
    return env->dir + "/seg-" + std::to_string(gen) + ".cxs";
}

// 1 = parsed (gen filled), 0 = file missing (fresh env), -1 = file
// exists but is unparseable. The distinction matters: treating a
// CORRUPT manifest as "fresh gen-0" would make open GC the live
// segment and WAL of whatever generation the env was really at —
// silent total data loss instead of a loud failed open.
int read_manifest_ex(const std::string& dir, uint64_t* gen_out) {
    *gen_out = 0;
    FILE* f = ::fopen((dir + "/MANIFEST").c_str(), "rb");
    if (!f) return 0;
    char buf[64] = {0};
    size_t n = ::fread(buf, 1, sizeof(buf) - 1, f);
    ::fclose(f);
    unsigned long long gen = 0;
    if (n < 8 || ::sscanf(buf, "CXMF001 %llu", &gen) != 1) return -1;
    *gen_out = static_cast<uint64_t>(gen);
    return 1;
}

// best-effort variant for change-detection comparisons only (a corrupt
// manifest reads as gen 0 there, which just forces a retry/reload that
// then fails loudly through read_manifest_ex)
uint64_t read_manifest(const std::string& dir) {
    uint64_t gen = 0;
    read_manifest_ex(dir, &gen);
    return gen;
}

bool write_all(int fd, const void* data, size_t len) {
    const char* p = static_cast<const char*>(data);
    while (len > 0) {
        ssize_t n = ::write(fd, p, len);
        if (n < 0) {
            if (errno == EINTR) continue;
            return false;
        }
        p += n;
        len -= static_cast<size_t>(n);
    }
    return true;
}

bool write_file_atomic(const std::string& dir, const std::string& name,
                       const std::string& contents) {
    std::string tmp = dir + "/" + name + ".tmp";
    int fd = ::open(tmp.c_str(), O_CREAT | O_TRUNC | O_WRONLY, 0644);
    if (fd < 0) return false;
    bool ok = write_all(fd, contents.data(), contents.size()) &&
              ::fsync(fd) == 0;
    ::close(fd);
    if (!ok) return false;
    if (::rename(tmp.c_str(), (dir + "/" + name).c_str()) != 0) return false;
    int dfd = ::open(dir.c_str(), O_RDONLY | O_DIRECTORY);
    if (dfd >= 0) {
        ::fsync(dfd);  // make the rename itself durable
        ::close(dfd);
    }
    return true;
}

void append_record(std::string* out, uint8_t op, const std::string& db,
                   const std::string& key, const std::string& val) {
    uint32_t dl = static_cast<uint32_t>(db.size());
    uint32_t kl = static_cast<uint32_t>(key.size());
    uint32_t vl = static_cast<uint32_t>(val.size());
    out->push_back(static_cast<char>(op));
    out->append(reinterpret_cast<char*>(&dl), 4);
    out->append(reinterpret_cast<char*>(&kl), 4);
    out->append(reinterpret_cast<char*>(&vl), 4);
    out->append(db);
    out->append(key);
    out->append(val);
}

int env_db_id(Env* env, const std::string& name) {
    auto it = env->db_ids.find(name);
    if (it != env->db_ids.end()) return it->second;
    int id = static_cast<int>(env->dbs.size());
    env->db_ids.emplace(name, id);
    env->db_names.push_back(name);
    env->dbs.emplace_back();
    if (env->segment) {
        auto sit = env->segment->dbs.find(name);
        if (sit != env->segment->dbs.end()) {
            env->dbs[id].seg = &sit->second;
            env->dbs[id].live = sit->second.count;
        }
    }
    return id;
}

bool db_seg_contains(const Env* env, const DbState& d,
                     const std::string& key) {
    if (!d.seg || !env->segment) return false;
    SegEntry e;
    return seg_find(*env->segment, *d.seg, key, &e);
}

bool db_visible(const Env* env, const DbState& d, const std::string& key) {
    if (d.puts.count(key)) return true;
    if (d.dels.count(key)) return false;
    return db_seg_contains(env, d, key);
}

// apply one committed record to the overlay, maintaining live counts and
// overlay accounting. Caller holds env->mu.
void apply_op(Env* env, uint8_t op, int id, const std::string& key,
              const std::string& val) {
    DbState& d = env->dbs[id];
    bool visible = db_visible(env, d, key);
    if (op == kOpPut) {
        if (!visible) d.live++;
        auto dit = d.dels.find(key);
        if (dit != d.dels.end()) {
            env->overlay_bytes -= key.size() + 64;
            d.dels.erase(dit);
        }
        auto res = d.puts.emplace(key, val);
        if (res.second) {
            env->overlay_bytes += key.size() + val.size() + 64;
        } else {
            env->overlay_bytes += val.size();
            env->overlay_bytes -= res.first->second.size();
            res.first->second = val;
        }
    } else if (op == kOpDel) {
        if (visible) d.live--;
        auto pit = d.puts.find(key);
        if (pit != d.puts.end()) {
            env->overlay_bytes -= key.size() + pit->second.size() + 64;
            d.puts.erase(pit);
        }
        if (db_seg_contains(env, d, key) && d.dels.insert(key).second) {
            env->overlay_bytes += key.size() + 64;
        }
    }
    env->wal_records++;
}

enum ReplayResult { kReplayOk, kReplayMissing, kReplayBad };

// Replay the WAL into the overlay from `from_offset` (0/8 = from the
// header). Truncated trailing records (torn writes from a crash) are
// discarded; only the initial open truncates them from disk.
ReplayResult replay_wal(Env* env, const std::string& path,
                        uint64_t from_offset, bool trim_tail) {
    FILE* f = ::fopen(path.c_str(), "rb");
    if (!f) return kReplayMissing;
    char magic[8];
    if (::fread(magic, 1, 8, f) != 8 || ::memcmp(magic, kMagic, 8) != 0) {
        ::fclose(f);
        env->error = "bad log magic";
        return kReplayBad;
    }
    if (from_offset > 8) {
        if (::fseek(f, static_cast<long>(from_offset), SEEK_SET) != 0) {
            ::fclose(f);
            return kReplayBad;
        }
    }
    // cap for the untrusted 32-bit length fields below: no record can
    // be larger than the file that holds it. Without this, bit-rot in
    // a length field makes resize() allocate-and-zero up to 12 GiB per
    // record, and the resulting bad_alloc would cross the extern "C"
    // boundary and abort the interpreter instead of failing the open.
    struct stat fst;
    uint64_t fsize = (::fstat(::fileno(f), &fst) == 0)
                         ? static_cast<uint64_t>(fst.st_size) : 0;
    std::string db, key, val;
    long good_end = static_cast<long>(from_offset > 8 ? from_offset : 8);
    for (;;) {
        uint8_t op;
        uint32_t dl, kl, vl;
        if (::fread(&op, 1, 1, f) != 1) break;
        if (::fread(&dl, 4, 1, f) != 1) break;
        if (::fread(&kl, 4, 1, f) != 1) break;
        if (::fread(&vl, 4, 1, f) != 1) break;
        if (op != kOpPut && op != kOpDel) break;  // unknown op: torn tail
        if (static_cast<uint64_t>(dl) + kl + vl > fsize) break;  // torn/rot
        db.resize(dl);
        key.resize(kl);
        val.resize(vl);
        if (dl && ::fread(&db[0], 1, dl, f) != dl) break;
        if (kl && ::fread(&key[0], 1, kl, f) != kl) break;
        if (vl && ::fread(&val[0], 1, vl, f) != vl) break;
        apply_op(env, op, env_db_id(env, db), key, val);
        good_end = ::ftell(f);
    }
    ::fclose(f);
    if (trim_tail) {
        // trim a torn tail so future appends start on a record boundary
        ::truncate(path.c_str(), good_end);
    }
    env->log_offset = static_cast<uint64_t>(good_end);
    return kReplayOk;
}

// (Re)load the current generation from disk: manifest -> segment mmap ->
// WAL replay -> append fd. Caller holds env->mu; trim_tail only when the
// caller holds the exclusive flock (open). `exclusive` means the caller
// holds the flock, so nothing can be mid-compaction: load failures are
// then genuine corruption and fail fast instead of being retried as
// races.
bool reload_locked(Env* env, bool trim_tail, bool exclusive) {
    for (int attempt = 0; attempt < 8; ++attempt) {
        uint64_t gen = 0;
        if (read_manifest_ex(env->dir, &gen) < 0) {
            env->error = "corrupt MANIFEST in " + env->dir +
                         " — refusing to treat the env as fresh "
                         "(that would GC the live segment/WAL)";
            return false;
        }
        auto seg = std::make_shared<Segment>();
        bool have_seg = false;
        struct stat st;
        if (::stat(seg_path(env, gen).c_str(), &st) == 0) {
            if (!seg->load(seg_path(env, gen))) {
                if (exclusive) {
                    env->error = "bad segment file " + seg_path(env, gen);
                    return false;
                }
                // mid-GC or mid-compaction by another process: retry
                continue;
            }
            have_seg = true;
        }
        // reset overlay state; db ids/names stay stable (callers hold ids)
        for (auto& d : env->dbs) {
            d.puts.clear();
            d.dels.clear();
            d.seg = nullptr;
            d.live = 0;
        }
        env->overlay_bytes = 0;
        env->segment = have_seg ? seg : nullptr;
        if (env->segment) {
            for (auto& it : env->segment->dbs) {
                int id = env_db_id(env, it.first);
                env->dbs[id].seg = &it.second;
                env->dbs[id].live = it.second.count;
            }
        }
        env->gen = gen;
        env->wal_records = 0;
        env->log_offset = 8;
        ReplayResult r = replay_wal(env, wal_path(env, gen), 0, trim_tail);
        if (r == kReplayBad) return false;
        if (r == kReplayMissing) {
            if (gen != read_manifest(env->dir)) continue;  // raced GC
            env->log_offset = 8;  // fresh env: header written below
        }
        if (env->log_fd >= 0) ::close(env->log_fd);
        env->log_fd = ::open(wal_path(env, gen).c_str(),
                             O_CREAT | O_WRONLY | O_APPEND, 0644);
        if (env->log_fd < 0) return false;
        if (::fstat(env->log_fd, &st) == 0 && st.st_size == 0) {
            if (!write_all(env->log_fd, kMagic, 8)) return false;
        }
        return true;
    }
    env->error = "reload kept racing generation changes";
    return false;
}

// Apply records other processes appended since we last read, following
// generation bumps. Caller holds env->mu (and the flock when mutating
// afterwards). Without this, compaction from a long-lived handle would
// rewrite the store from stale memory and drop their committed data.
bool catch_up_locked(Env* env) {
    for (int attempt = 0; attempt < 8; ++attempt) {
        uint64_t gen = 0;
        if (read_manifest_ex(env->dir, &gen) < 0) {
            env->error = "corrupt MANIFEST during catch-up";
            return false;
        }
        if (gen != env->gen) {
            if (reload_locked(env, /*trim_tail=*/false,
                              /*exclusive=*/false)) {
                return true;
            }
            // reload resets the overlay before replaying: a failure
            // here leaves the handle with a cleared/partial view while
            // disk stays consistent. Mark it errored (same policy as
            // the commit spill path) so callers get a distinct rc and
            // readers aren't silently served vanishing keys forever.
            if (env->error.empty()) {
                env->error = "reload failed during catch-up; "
                             "reopen the env";
            }
            env->failed = true;
            return false;
        }
        ReplayResult r = replay_wal(env, wal_path(env, env->gen),
                                    env->log_offset, /*trim_tail=*/false);
        if (r == kReplayOk) return true;
        if (r == kReplayBad) return false;
        // file vanished: another process rotated generations; retry
        if (gen == read_manifest(env->dir) && env->gen == 0) {
            return true;  // fresh gen-0 env, WAL not created yet
        }
    }
    return false;
}

// merge iterator over one db: segment entries (minus tombstones and
// overridden keys) interleaved with overlay puts, in byte order
struct MergeIter {
    const Env* env;
    const DbState* d;
    uint64_t si = 0;
    Map::const_iterator pit;

    explicit MergeIter(const Env* e, const DbState* db) : env(e), d(db) {
        pit = d->puts.begin();
    }

    bool next(SegEntry* out) {
        const Segment* s = env->segment.get();
        for (;;) {
            bool have_seg = d->seg && s && si < d->seg->count;
            bool have_put = pit != d->puts.end();
            if (!have_seg && !have_put) return false;
            if (have_seg) {
                SegEntry e = seg_entry(*s, *d->seg, si);
                int cmp = have_put ? seg_key_cmp(e, pit->first) : -1;
                if (cmp < 0) {
                    std::string k(e.key, e.klen);
                    if (d->dels.count(k) || d->puts.count(k)) {
                        // tombstoned, or overridden by a later put that
                        // the put iterator already emitted / will emit
                        si++;
                        continue;
                    }
                    si++;
                    *out = e;
                    return true;
                }
                if (cmp == 0) si++;  // overridden: fall through to put
            }
            out->key = pit->first.data();
            out->klen = static_cast<uint32_t>(pit->first.size());
            out->val = pit->second.data();
            out->vlen = static_cast<uint32_t>(pit->second.size());
            ++pit;
            return true;
        }
    }
};

// Rewrite segment+overlay as generation gen+1 and rotate the WAL. Caller
// holds env->mu AND the exclusive flock (so no other process can append
// between the catch-up and the manifest bump).
bool compact_locked(Env* env) {
    // fault injection for tests: simulate a compaction failure before
    // any state is touched, so the spill path's recovery (reload to a
    // coherent handle, commit still durable) is testable from Python
    if (::getenv("CXKV_TEST_FAIL_COMPACT")) return false;
    if (!catch_up_locked(env)) return false;  // never drop others' data
    uint64_t new_gen = env->gen + 1;

    // pass 1: layout. Dbs in sorted-name order for determinism.
    struct DbPlan {
        std::string name;
        int id;
        uint64_t count = 0;
        uint64_t bytes = 0;  // record bytes
    };
    std::vector<DbPlan> plans;
    for (const auto& it : env->db_ids) {
        const DbState& d = env->dbs[it.second];
        DbPlan p;
        p.name = it.first;
        p.id = it.second;
        MergeIter mi(env, &d);
        SegEntry e;
        while (mi.next(&e)) {
            p.count++;
            p.bytes += 8 + e.klen + e.vlen;
        }
        if (p.count) plans.push_back(std::move(p));
    }
    uint64_t header = 12;  // magic + n_dbs
    for (const auto& p : plans) header += 4 + p.name.size() + 16;
    uint64_t pos = header;
    std::vector<uint64_t> index_offs(plans.size());
    std::vector<uint64_t> rec_offs(plans.size());
    for (size_t i = 0; i < plans.size(); ++i) {
        index_offs[i] = pos;
        pos += plans[i].count * 8;
        rec_offs[i] = pos;
        pos += plans[i].bytes;
    }

    // pass 2: emit
    std::string tmp = seg_path(env, new_gen) + ".tmp";
    int fd = ::open(tmp.c_str(), O_CREAT | O_TRUNC | O_WRONLY, 0644);
    if (fd < 0) return false;
    std::string buf(kSegMagic, 8);
    uint32_t n_dbs = static_cast<uint32_t>(plans.size());
    buf.append(reinterpret_cast<char*>(&n_dbs), 4);
    for (size_t i = 0; i < plans.size(); ++i) {
        uint32_t nl = static_cast<uint32_t>(plans[i].name.size());
        buf.append(reinterpret_cast<char*>(&nl), 4);
        buf.append(plans[i].name);
        buf.append(reinterpret_cast<char*>(&plans[i].count), 8);
        buf.append(reinterpret_cast<char*>(&index_offs[i]), 8);
    }
    auto flush_if_big = [&]() -> bool {
        if (buf.size() > (16u << 20)) {
            if (!write_all(fd, buf.data(), buf.size())) return false;
            buf.clear();
        }
        return true;
    };
    bool ok = true;
    for (size_t i = 0; i < plans.size() && ok; ++i) {
        // offsets array
        const DbState& d = env->dbs[plans[i].id];
        uint64_t off = rec_offs[i];
        MergeIter mi(env, &d);
        SegEntry e;
        while (mi.next(&e)) {
            buf.append(reinterpret_cast<char*>(&off), 8);
            off += 8 + e.klen + e.vlen;
            if (!flush_if_big()) { ok = false; break; }
        }
        if (!ok) break;
        // records
        MergeIter mi2(env, &d);
        while (mi2.next(&e)) {
            buf.append(reinterpret_cast<char*>(&e.klen), 4);
            buf.append(reinterpret_cast<char*>(&e.vlen), 4);
            buf.append(e.key, e.klen);
            buf.append(e.val, e.vlen);
            if (!flush_if_big()) { ok = false; break; }
        }
    }
    if (ok && !buf.empty()) ok = write_all(fd, buf.data(), buf.size());
    if (ok) ok = ::fsync(fd) == 0;
    ::close(fd);
    if (!ok) {
        ::unlink(tmp.c_str());
        return false;
    }
    if (::rename(tmp.c_str(), seg_path(env, new_gen).c_str()) != 0) {
        return false;
    }

    // fresh WAL for the new generation, then flip the manifest
    std::string new_wal = wal_path(env, new_gen);
    int wfd = ::open(new_wal.c_str(), O_CREAT | O_TRUNC | O_WRONLY, 0644);
    if (wfd < 0) return false;
    ok = write_all(wfd, kMagic, 8) && ::fsync(wfd) == 0;
    ::close(wfd);
    if (!ok) return false;
    if (!write_file_atomic(env->dir, "MANIFEST",
                           "CXMF001 " + std::to_string(new_gen) + "\n")) {
        return false;
    }

    std::string old_seg = seg_path(env, env->gen);
    std::string old_wal = wal_path(env, env->gen);
    if (!reload_locked(env, /*trim_tail=*/false,
                       /*exclusive=*/true)) {
        return false;
    }
    // other processes on the old generation reload at their next
    // commit/refresh (manifest check); files unlinked now, their handles
    // reopen from the new generation
    ::unlink(old_seg.c_str());
    ::unlink(old_wal.c_str());
    return true;
}

// remove segment/WAL files from other generations (crash leftovers).
// Caller holds the exclusive flock.
void gc_stale_files_locked(Env* env) {
    DIR* dir = ::opendir(env->dir.c_str());
    if (!dir) return;
    std::string keep_seg = seg_path(env, env->gen);
    std::string keep_wal = wal_path(env, env->gen);
    while (struct dirent* de = ::readdir(dir)) {
        std::string name = de->d_name;
        std::string full = env->dir + "/" + name;
        bool stale = false;
        size_t n = name.size();
        if (n > 4 && name.compare(n - 4, 4, ".tmp") == 0) {
            stale = true;
        } else if (name.rfind("seg-", 0) == 0 && full != keep_seg) {
            stale = true;
        } else if (name.rfind("wal-", 0) == 0 && full != keep_wal) {
            stale = true;
        } else if (name == "data.cxkv" && env->gen != 0) {
            stale = true;
        }
        if (stale) ::unlink(full.c_str());
    }
    ::closedir(dir);
}

struct PendingOp {
    uint8_t op;
    int db;
    std::string key;
    std::string val;
};

struct Txn {
    Env* env;
    bool write;
    bool done = false;
    std::vector<PendingOp> ops;        // buffered writes
    std::deque<std::string> read_buf;  // keeps get() results alive
};

struct Cursor {
    Env* env;
    Txn* txn;
    int db;
    bool started = false;
    std::string current_key;
    std::deque<std::string> buf;
};

}  // namespace

extern "C" {

void* cxkv_open(const char* path) {
    auto env = std::make_unique<Env>();
    env->dir = path;
    env->memtable_cap = memtable_cap_bytes();
    ::mkdir(path, 0755);
    std::string lp = env->dir + "/LOCK";
    env->lock_fd = ::open(lp.c_str(), O_CREAT | O_RDWR, 0644);
    if (env->lock_fd < 0) return nullptr;
    // The open-time replay trims torn WAL tails from disk. Without the
    // exclusive flock, a record that merely hasn't finished being
    // appended by a live writer is indistinguishable from a crash
    // remnant: truncating it would chop a committed-in-progress
    // transaction whose writer then appends the remainder at the new
    // EOF and reports it durable. Hold the flock so a partial record
    // seen here really is a torn tail.
    if (::flock(env->lock_fd, LOCK_EX) != 0) {
        ::close(env->lock_fd);
        return nullptr;
    }
    bool ok = reload_locked(env.get(), /*trim_tail=*/true,
                            /*exclusive=*/true);
    if (ok) gc_stale_files_locked(env.get());
    ::flock(env->lock_fd, LOCK_UN);
    if (!ok) {
        if (env->log_fd >= 0) ::close(env->log_fd);
        ::close(env->lock_fd);
        return nullptr;
    }
    return env.release();
}

void cxkv_close(void* handle) {
    Env* env = static_cast<Env*>(handle);
    if (!env) return;
    {
        std::lock_guard<std::mutex> wl(env->wlock_mu);  // see wlock_mu decl
        std::lock_guard<std::mutex> g(env->mu);
        // fold a bulk ingest into the segment so the next open is cheap
        if (env->wal_records >= kCloseCompactWalRecords &&
            ::flock(env->lock_fd, LOCK_EX) == 0) {
            // compact_locked requires the exclusive flock: it rewrites
            // the store from memory after a catch-up, and a commit
            // landing between the catch-up and the manifest bump would
            // be dropped.
            compact_locked(env);
            ::flock(env->lock_fd, LOCK_UN);
        }
    }
    if (env->log_fd >= 0) ::close(env->log_fd);
    if (env->lock_fd >= 0) ::close(env->lock_fd);
    delete env;
}

int cxkv_db(void* handle, const char* name) {
    Env* env = static_cast<Env*>(handle);
    std::lock_guard<std::mutex> g(env->mu);
    return env_db_id(env, name);
}

uint64_t cxkv_entries(void* handle, int db) {
    Env* env = static_cast<Env*>(handle);
    std::lock_guard<std::mutex> g(env->mu);
    if (db < 0 || db >= static_cast<int>(env->dbs.size())) return 0;
    return env->dbs[db].live;
}

void* cxkv_txn_begin(void* handle, int write) {
    Env* env = static_cast<Env*>(handle);
    auto txn = std::make_unique<Txn>();
    txn->env = env;
    txn->write = write != 0;
    return txn.release();
}

// a db id from some OTHER Environment (an easy caller mixup — handles
// are small ints) must not index out of bounds at commit time
static bool db_id_valid(Txn* txn, int db) {
    std::lock_guard<std::mutex> g(txn->env->mu);
    return db >= 0 && db < static_cast<int>(txn->env->dbs.size());
}

int cxkv_put(void* th, int db, const char* k, size_t klen,
             const char* v, size_t vlen) {
    Txn* txn = static_cast<Txn*>(th);
    if (!txn->write || txn->done || !db_id_valid(txn, db)) return -1;
    txn->ops.push_back({kOpPut, db, std::string(k, klen), std::string(v, vlen)});
    return 0;
}

int cxkv_del(void* th, int db, const char* k, size_t klen) {
    Txn* txn = static_cast<Txn*>(th);
    if (!txn->write || txn->done || !db_id_valid(txn, db)) return -1;
    txn->ops.push_back({kOpDel, db, std::string(k, klen), std::string()});
    return 0;
}

// Park a returned value in the txn's read buffer. BOUNDED: callers
// (the ctypes binding) copy the value immediately after each call, so
// only a few recent entries need to stay alive — retaining every value
// ever read made a full-corpus txn.get scan hold the whole corpus in
// RAM (the RSS class the LSM redesign exists to eliminate).
static const char* stash_value(Txn* txn, const char* data, size_t len,
                               size_t* vlen) {
    if (txn->read_buf.size() >= 8) txn->read_buf.pop_front();
    txn->read_buf.emplace_back(data, len);
    *vlen = len;
    return txn->read_buf.back().data();
}

const char* cxkv_get(void* th, int db, const char* k, size_t klen,
                     size_t* vlen) {
    Txn* txn = static_cast<Txn*>(th);
    Env* env = txn->env;
    std::string key(k, klen);
    // read-your-writes: newest pending op on this key wins
    for (auto it = txn->ops.rbegin(); it != txn->ops.rend(); ++it) {
        if (it->db == db && it->key == key) {
            if (it->op == kOpDel) return nullptr;
            return stash_value(txn, it->val.data(), it->val.size(), vlen);
        }
    }
    std::lock_guard<std::mutex> g(env->mu);
    if (db < 0 || db >= static_cast<int>(env->dbs.size())) return nullptr;
    const DbState& d = env->dbs[db];
    auto pit = d.puts.find(key);
    if (pit != d.puts.end()) {
        return stash_value(txn, pit->second.data(), pit->second.size(),
                           vlen);
    }
    if (d.dels.count(key)) return nullptr;
    SegEntry e;
    if (d.seg && env->segment && seg_find(*env->segment, *d.seg, key, &e)) {
        return stash_value(txn, e.val, e.vlen, vlen);
    }
    return nullptr;
}

int cxkv_txn_commit(void* th) {
    std::unique_ptr<Txn> txn(static_cast<Txn*>(th));
    if (txn->done) return -1;
    txn->done = true;
    if (!txn->write || txn->ops.empty()) return 0;
    Env* env = txn->env;
    if (env->failed) return -5;  // handle errored; reopen the env

    // cross-process single-writer: hold the flock only for the commit.
    // wlock_mu first — see its declaration: without it a sibling
    // thread's LOCK_EX would no-op on the shared fd and our LOCK_UN
    // below would release the lock out from under it.
    std::lock_guard<std::mutex> wl(env->wlock_mu);
    if (::flock(env->lock_fd, LOCK_EX) != 0) return -2;
    std::lock_guard<std::mutex> g(env->mu);
    // fold in records other processes appended (or generations they
    // rotated) since we last read, so our in-memory state and log_offset
    // match the file before we extend it
    if (!catch_up_locked(env)) {
        ::flock(env->lock_fd, LOCK_UN);
        return -4;
    }
    // a process that died mid-append leaves a torn tail; appending after
    // it would orphan our records behind an unparseable prefix. We hold
    // the exclusive flock, so trimming is safe.
    struct stat st;
    if (::stat(wal_path(env, env->gen).c_str(), &st) == 0 &&
        static_cast<uint64_t>(st.st_size) != env->log_offset) {
        ::truncate(wal_path(env, env->gen).c_str(), env->log_offset);
    }
    std::string buf;
    for (const auto& op : txn->ops) {
        append_record(&buf, op.op, env->db_names[op.db], op.key, op.val);
    }
    bool ok = write_all(env->log_fd, buf.data(), buf.size()) &&
              ::fdatasync(env->log_fd) == 0;
    if (ok) {
        for (const auto& op : txn->ops) {
            apply_op(env, op.op, op.db, op.key, op.val);
        }
        env->log_offset += buf.size();
        // memtable bound: spill the overlay into a new segment so RSS
        // never scales with total ingest (we already hold the flock)
        if (env->overlay_bytes >= env->memtable_cap) {
            // best-effort: the commit is already durable in the WAL. But
            // a *partial* failure (e.g. reload after the MANIFEST flip)
            // can leave the overlay cleared or log_fd stale while disk
            // stays consistent — reload to restore coherent in-memory
            // state; if even that fails, mark the handle errored so
            // callers get a distinct rc instead of opaque -3s forever
            if (!compact_locked(env) &&
                !reload_locked(env, /*trim_tail=*/false,
                               /*exclusive=*/true)) {
                if (env->error.empty()) {
                    env->error = "memtable spill failed and the handle "
                                 "could not reload; reopen the env";
                }
                env->failed = true;
            }
        }
    }
    ::flock(env->lock_fd, LOCK_UN);
    return ok ? 0 : -3;
}

void cxkv_txn_abort(void* th) {
    std::unique_ptr<Txn> txn(static_cast<Txn*>(th));
    if (txn) txn->done = true;
}

void* cxkv_cursor_open(void* th, int db) {
    Txn* txn = static_cast<Txn*>(th);
    auto cur = std::make_unique<Cursor>();
    cur->env = txn->env;
    cur->txn = txn;
    cur->db = db;
    return cur.release();
}

// Shared advance: mode 0 = first, 1 = next (strictly after current_key).
// Returns 1 and fills k/v on success, 0 at end. Merges the mmap-ed
// segment with the overlay, honoring tombstones and overrides; holding
// only the current key (copied) makes segment swaps under a live cursor
// safe — the cursor continues at the next key in the new generation.
static int cursor_step(Cursor* cur, int mode, const char** k, size_t* klen,
                       const char** v, size_t* vlen) {
    Env* env = cur->env;
    std::lock_guard<std::mutex> g(env->mu);
    if (cur->db < 0 || cur->db >= static_cast<int>(env->dbs.size())) return 0;
    const DbState& d = env->dbs[cur->db];
    const Segment* s = env->segment.get();

    uint64_t si = 0;
    Map::const_iterator pit;
    if (mode == 0) {
        pit = d.puts.begin();
    } else {
        pit = d.puts.upper_bound(cur->current_key);
        if (d.seg && s) si = seg_lower_bound(*s, *d.seg, cur->current_key);
    }
    std::string key, val;
    for (;;) {
        // advance the segment side past current_key / tombstones
        bool have_seg = d.seg && s && si < d.seg->count;
        SegEntry e;
        if (have_seg) {
            e = seg_entry(*s, *d.seg, si);
            if (mode != 0 && seg_key_cmp(e, cur->current_key) <= 0) {
                si++;
                continue;
            }
        }
        bool have_put = pit != d.puts.end();
        if (!have_seg && !have_put) return 0;
        if (have_seg) {
            int cmp = have_put ? seg_key_cmp(e, pit->first) : -1;
            if (cmp < 0) {
                key.assign(e.key, e.klen);
                if (d.dels.count(key)) {
                    si++;
                    continue;
                }
                val.assign(e.val, e.vlen);
                break;
            }
            if (cmp == 0) {
                si++;  // overridden by the put at the same key
            }
        }
        key = pit->first;
        val = pit->second;
        break;
    }
    cur->started = true;
    cur->current_key = key;
    cur->buf.clear();
    cur->buf.push_back(std::move(key));
    cur->buf.push_back(std::move(val));
    *k = cur->buf[0].data();
    *klen = cur->buf[0].size();
    *v = cur->buf[1].data();
    *vlen = cur->buf[1].size();
    return 1;
}

int cxkv_cursor_first(void* ch, const char** k, size_t* klen,
                      const char** v, size_t* vlen) {
    return cursor_step(static_cast<Cursor*>(ch), 0, k, klen, v, vlen);
}

int cxkv_cursor_next(void* ch, const char** k, size_t* klen,
                     const char** v, size_t* vlen) {
    Cursor* cur = static_cast<Cursor*>(ch);
    return cursor_step(cur, cur->started ? 1 : 0, k, klen, v, vlen);
}

void cxkv_cursor_close(void* ch) {
    delete static_cast<Cursor*>(ch);
}

int cxkv_compact(void* handle) {
    Env* env = static_cast<Env*>(handle);
    std::lock_guard<std::mutex> wl(env->wlock_mu);  // see wlock_mu decl
    if (::flock(env->lock_fd, LOCK_EX) != 0) return -1;
    std::lock_guard<std::mutex> g(env->mu);
    bool ok = compact_locked(env);
    ::flock(env->lock_fd, LOCK_UN);
    return ok ? 0 : -2;
}

int cxkv_refresh(void* handle) {
    // pick up records committed (and generations rotated) by other
    // processes since open/last refresh (a reader that wants live data
    // calls this; a partially appended tail simply stops the parse and
    // is retried next time)
    Env* env = static_cast<Env*>(handle);
    std::lock_guard<std::mutex> g(env->mu);
    return catch_up_locked(env) ? 0 : -1;
}

int cxkv_sync(void* handle) {
    Env* env = static_cast<Env*>(handle);
    std::lock_guard<std::mutex> g(env->mu);
    return ::fdatasync(env->log_fd) == 0 ? 0 : -1;
}

// test/tooling introspection: current generation and overlay footprint
uint64_t cxkv_generation(void* handle) {
    Env* env = static_cast<Env*>(handle);
    std::lock_guard<std::mutex> g(env->mu);
    return env->gen;
}

uint64_t cxkv_overlay_bytes(void* handle) {
    Env* env = static_cast<Env*>(handle);
    std::lock_guard<std::mutex> g(env->mu);
    return env->overlay_bytes;
}

// last error description ("" when none). The pointer stays valid until
// the next env operation that sets an error, or close.
const char* cxkv_error(void* handle) {
    Env* env = static_cast<Env*>(handle);
    std::lock_guard<std::mutex> g(env->mu);
    return env->error.c_str();
}

}  // extern "C"
