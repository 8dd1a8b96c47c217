// Native host runtime ops for arroyo_tpu.
//
// The reference implements its entire host data plane in Rust; here the
// Python host runtime offloads its per-batch hot loops to this library
// (loaded via ctypes, with numpy-based fallbacks kept in sync — see
// arroyo_tpu/native/__init__.py):
//
//  * splitmix64 key hashing (must match arroyo_tpu.types.hash_u64 bit-for-
//    bit: sharding and checkpoint key ranges depend on it),
//  * composite multi-column hash combining,
//  * shuffle partition routing: key_hash -> destination shard, stable
//    counting-sort order and per-destination bounds in one O(n) pass
//    (replaces argsort+searchsorted in the collector fan-out; semantics of
//    server_for_hash per arroyo-types/src/lib.rs:822-836),
//  * event-time window-bin assignment fused with liveness filtering (the
//    host half of the device bin-ring update).

#include <cstdint>
#include <cstring>

extern "C" {

// bump when any exported signature changes so the Python loader rebuilds
// a stale cached .so instead of calling through a mismatched ABI
int64_t arroyo_abi_version() { return 2; }

static inline uint64_t splitmix64(uint64_t z) {
    z += 0x9E3779B97F4A7C15ULL;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

// out[i] = splitmix64(in[i]); matches types.hash_u64
void arroyo_hash_u64(const uint64_t* in, uint64_t* out, int64_t n) {
    for (int64_t i = 0; i < n; i++) out[i] = splitmix64(in[i]);
}

// acc[i] = splitmix64(acc[i] * 31 + h[i]); matches types.hash_columns
void arroyo_hash_combine(uint64_t* acc, const uint64_t* h, int64_t n) {
    for (int64_t i = 0; i < n; i++)
        acc[i] = splitmix64(acc[i] * 31ULL + h[i]);
}

// Key-range partition routing (server_for_hash semantics):
//   dest[i]  = min(n_parts-1, kh[i] / (U64_MAX / n_parts))
//   order    = stable permutation sorting rows by dest (counting sort)
//   bounds   = [n_parts+1] prefix offsets into order per destination
void arroyo_partition_route(const uint64_t* kh, int64_t n, int32_t n_parts,
                            int32_t* dest, int64_t* order, int64_t* bounds) {
    const uint64_t range = 0xFFFFFFFFFFFFFFFFULL / (uint64_t)n_parts;
    for (int64_t i = 0; i < n; i++) {
        uint64_t d = kh[i] / range;
        if (d >= (uint64_t)n_parts) d = n_parts - 1;
        dest[i] = (int32_t)d;
    }
    // counting sort: stable, O(n + n_parts)
    for (int32_t p = 0; p <= n_parts; p++) bounds[p] = 0;
    for (int64_t i = 0; i < n; i++) bounds[dest[i] + 1]++;
    for (int32_t p = 0; p < n_parts; p++) bounds[p + 1] += bounds[p];
    int64_t* cursor = new int64_t[n_parts];
    std::memcpy(cursor, bounds, n_parts * sizeof(int64_t));
    for (int64_t i = 0; i < n; i++) order[cursor[dest[i]]++] = i;
    delete[] cursor;
}

// Window-bin assignment for the keyed bin-ring update:
//   bins[i] = (ts[i] / slide) % ring  for rows at or after the liveness
//   threshold (min live absolute bin); dead rows get live[i] = 0.
// Returns the number of live rows; fills abs_min/abs_max over live rows.
int64_t arroyo_assign_bins(const int64_t* ts, int64_t n, int64_t slide,
                           int64_t ring, int64_t threshold, /* INT64_MIN if none */
                           int32_t* bins, uint8_t* live,
                           int64_t* abs_min, int64_t* abs_max) {
    int64_t lo = INT64_MAX, hi = INT64_MIN, count = 0;
    for (int64_t i = 0; i < n; i++) {
        // floor division (numpy // semantics), not C++ truncation
        int64_t ab = ts[i] >= 0 ? ts[i] / slide
                                : -((-ts[i] + slide - 1) / slide);
        uint8_t ok = ab >= threshold;
        live[i] = ok;
        int64_t m = ab % ring;
        bins[i] = (int32_t)(m < 0 ? m + ring : m);
        if (ok) {
            count++;
            if (ab < lo) lo = ab;
            if (ab > hi) hi = ab;
        }
    }
    *abs_min = lo;
    *abs_max = hi;
    return count;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Persistent key directory: open-addressing hash table key_hash -> slot.
//
// Replaces the sorted-array + np.searchsorted directory maintenance in
// ops/keyed_bins.py (directory_insert): one O(n) linear-probe pass per
// batch instead of O(n log C) binary search + merge sort.  The Python side
// keeps slot_to_key/key_sorted as the checkpointable source of truth and
// rebuilds this table on restore via arroyo_dir_load.
// ---------------------------------------------------------------------------

extern "C" {

struct ArroyoDir {
    uint64_t* keys;
    int64_t* slots;   // -1 = empty
    uint64_t cap;     // power of two
    uint64_t mask;
    uint64_t size;
};

static void dir_alloc(ArroyoDir* d, uint64_t cap) {
    d->keys = new uint64_t[cap];
    d->slots = new int64_t[cap];
    d->cap = cap;
    d->mask = cap - 1;
    d->size = 0;
    for (uint64_t i = 0; i < cap; i++) d->slots[i] = -1;
}

void* arroyo_dir_new(int64_t cap_hint) {
    uint64_t cap = 64;
    while ((int64_t)cap < cap_hint * 2) cap <<= 1;
    ArroyoDir* d = new ArroyoDir;
    dir_alloc(d, cap);
    return d;
}

void arroyo_dir_free(void* h) {
    ArroyoDir* d = (ArroyoDir*)h;
    delete[] d->keys;
    delete[] d->slots;
    delete d;
}

static void dir_grow(ArroyoDir* d) {
    uint64_t* ok = d->keys;
    int64_t* os = d->slots;
    uint64_t ocap = d->cap;
    dir_alloc(d, ocap << 1);
    for (uint64_t i = 0; i < ocap; i++) {
        if (os[i] < 0) continue;
        uint64_t j = splitmix64(ok[i]) & d->mask;
        while (d->slots[j] >= 0) j = (j + 1) & d->mask;
        d->keys[j] = ok[i];
        d->slots[j] = os[i];
        d->size++;
    }
    delete[] ok;
    delete[] os;
}

// Bulk load explicit (key, slot) pairs (checkpoint restore).
void arroyo_dir_load(void* h, const uint64_t* keys, const int64_t* slots,
                     int64_t n) {
    ArroyoDir* d = (ArroyoDir*)h;
    for (int64_t i = 0; i < n; i++) {
        if ((d->size + 1) * 10 > d->cap * 7) dir_grow(d);
        uint64_t j = splitmix64(keys[i]) & d->mask;
        while (d->slots[j] >= 0 && d->keys[j] != keys[i])
            j = (j + 1) & d->mask;
        if (d->slots[j] < 0) d->size++;
        d->keys[j] = keys[i];
        d->slots[j] = slots[i];
    }
}

// Lookup-or-insert a batch.  Unknown keys get sequential slots starting at
// next_slot, in first-appearance order; their hashes are appended to
// out_new_keys.  Returns the number of new keys.
int64_t arroyo_dir_insert(void* h, const uint64_t* kh, int64_t n,
                          int64_t next_slot, int64_t* out_slots,
                          uint64_t* out_new_keys) {
    ArroyoDir* d = (ArroyoDir*)h;
    int64_t n_new = 0;
    for (int64_t i = 0; i < n; i++) {
        if ((d->size + 1) * 10 > d->cap * 7) dir_grow(d);
        uint64_t k = kh[i];
        uint64_t j = splitmix64(k) & d->mask;
        while (d->slots[j] >= 0 && d->keys[j] != k) j = (j + 1) & d->mask;
        if (d->slots[j] < 0) {
            d->keys[j] = k;
            d->slots[j] = next_slot + n_new;
            d->size++;
            out_new_keys[n_new++] = k;
        }
        out_slots[i] = d->slots[j];
    }
    return n_new;
}

// Lookup only (emission-time key recovery); missing keys -> -1.
void arroyo_dir_lookup(void* h, const uint64_t* kh, int64_t n,
                       int64_t* out_slots) {
    ArroyoDir* d = (ArroyoDir*)h;
    for (int64_t i = 0; i < n; i++) {
        uint64_t k = kh[i];
        uint64_t j = splitmix64(k) & d->mask;
        while (d->slots[j] >= 0 && d->keys[j] != k) j = (j + 1) & d->mask;
        out_slots[i] = d->slots[j] < 0 ? -1 : d->slots[j];
    }
}

// ---------------------------------------------------------------------------
// (slot, bin) cell pre-aggregation — the two-phase local half
// (TumblingLocalAggregator analog) in one O(n) hash pass, replacing the
// np.lexsort + reduceat path in ops/keyed_bins.py preaggregate().
//
//   kinds[c]: 0 = additive (sum/count), 1 = min, 2 = max
//   vals is [n_ch, n] C-contiguous; live rows only are aggregated.
//   Outputs are in first-appearance order; returns n_cells.
// ---------------------------------------------------------------------------

int64_t arroyo_agg_cells(const int64_t* slots, const int32_t* bins,
                         const uint8_t* live, int64_t n, int64_t ring,
                         const double* vals, const uint8_t* kinds,
                         int32_t n_ch,
                         int64_t* out_slot, int32_t* out_bin,
                         double* out_cnt, double* out_vals) {
    uint64_t cap = 64;
    while ((int64_t)cap < n * 2) cap <<= 1;
    const uint64_t mask = cap - 1;
    uint64_t* ckey = new uint64_t[cap];
    int64_t* cidx = new int64_t[cap];  // -1 = empty, else cell index
    for (uint64_t i = 0; i < cap; i++) cidx[i] = -1;

    int64_t n_cells = 0;
    for (int64_t i = 0; i < n; i++) {
        if (live && !live[i]) continue;
        uint64_t key = (uint64_t)slots[i] * (uint64_t)ring + (uint64_t)bins[i];
        uint64_t j = splitmix64(key) & mask;
        while (cidx[j] >= 0 && ckey[j] != key) j = (j + 1) & mask;
        int64_t c = cidx[j];
        if (c < 0) {
            c = n_cells++;
            ckey[j] = key;
            cidx[j] = c;
            out_slot[c] = slots[i];
            out_bin[c] = bins[i];
            out_cnt[c] = 1.0;
            for (int32_t ch = 0; ch < n_ch; ch++)
                out_vals[ch * n + c] = vals[ch * n + i];
        } else {
            out_cnt[c] += 1.0;
            for (int32_t ch = 0; ch < n_ch; ch++) {
                double v = vals[ch * n + i];
                double* acc = &out_vals[ch * n + c];
                if (kinds[ch] == 1) { if (v < *acc) *acc = v; }
                else if (kinds[ch] == 2) { if (v > *acc) *acc = v; }
                else *acc += v;
            }
        }
    }
    delete[] ckey;
    delete[] cidx;
    return n_cells;
}

}  // extern "C"
