// Native (host-side) range-coder runtime of the PyTorch port.
//
// A copy of cpp/range_coder.cpp, the JAX package's runtime, kept by the
// port (which builds and loads nothing of that package): built with g++
// by fpsc_tpu_torch/ops/host_build.py into build/host/ at first use and
// bound by fpsc_tpu_torch/codec/native_rc.py.  Its bytes and symbols are
// held to the JAX runtime's and to the port's Python coder's in
// tests/test_torch_native_rc.py.
//
// Exact C++ re-implementation of the entropy layer in
// fpsc_tpu_torch/codec/range_coder.py (the Python module remains the
// reference implementation and the parity oracle): the carry-less
// 32-bit range coder, the adaptive frequency tables (increment 24,
// halving rescale past 4096) and the full utterance walker with every
// context chain (indicator run buckets, voicing-conditioned pitch
// deltas with absolute escapes, value-rank scalar bucket chains,
// stage-conditioned VQ models).
//
// The Python walker costs ~0.28 ms per frame (the per-symbol table
// rebuild is an O(n) numpy cumsum + object dispatch); serving at
// scale wants the entropy layer native, like the reference's
// bit-exact paths live in xiph/LPCNet's C.  This file keeps the SAME
// integer semantics (Python arbitrary-precision masked arithmetic is
// replicated with uint64/int64, including the floor-division and
// numpy negative-index edge cases) so the two backends are
// interchangeable mid-stream.
//
// Table arena: Python (fpsc_tpu_torch/codec/native_rc.py) seeds every
// adaptive table with range_coder._prior_table — the prior-mass
// arithmetic lives in ONE place — and ships the flattened counts in
// the canonical slot order documented in native_rc.py; this file
// only indexes slots, it never re-derives seeding.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t TOP = 1ull << 24;
constexpr uint64_t BOT = 1ull << 16;
constexpr uint64_t M32 = 0xFFFFFFFFull;
constexpr uint64_t M48 = 0xFFFFFFFFFFFFull;
constexpr int64_t INCREMENT = 24;   // AdaptiveFreqTable defaults
constexpr int64_t LIMIT = 1ll << 12;

constexpr int PITCH_DELTA_RANGE = 32;
constexpr int PITCH_ESCAPE = 2 * PITCH_DELTA_RANGE;  // symbol 64
constexpr int VQ_CTX = 4;
constexpr int IND_RUN_CTX = 6;
constexpr int PITCH_V_CTX = 3;

struct NeedBytes {};  // mirrors range_coder.NeedBytes

// ---------------------------------------------------------------- tables

struct Table {
  int n = 0;
  bool adaptive = true;
  std::vector<int64_t> counts;  // adaptive: counts; static: scaled freq
  std::vector<int64_t> cum;     // n + 1 entries
  int64_t total = 0;

  void rebuild() {
    cum.resize(n + 1);
    cum[0] = 0;
    for (int i = 0; i < n; ++i) cum[i + 1] = cum[i] + counts[i];
    total = cum[n];
  }
  // np.searchsorted(cum, value, side="right") - 1
  int find(int64_t value) const {
    return int(std::upper_bound(cum.begin(), cum.end(), value) -
               cum.begin()) - 1;
  }
  // numpy negative indexing: cum[-1] == cum[n], freq[-1] == freq[n-1]
  int64_t cum_at(int sym) const { return cum[sym < 0 ? n + 1 + sym : sym]; }
  int64_t freq_at(int sym) const {
    return counts[sym < 0 ? n + sym : sym];
  }
  void update(int sym) {
    if (!adaptive) return;
    counts[sym < 0 ? n + sym : sym] += INCREMENT;
    int64_t s = 0;
    for (int64_t c : counts) s += c;
    if (s > LIMIT)
      for (int64_t& c : counts) c = std::max<int64_t>(1, c >> 1);
    rebuild();
  }
};

// ---------------------------------------------------------------- coder

struct Encoder {
  uint64_t low = 0, range = M32;
  std::vector<uint8_t> out;

  void encode(const Table& t, int sym) {
    uint64_t r = range / (uint64_t)t.total;
    low = (low + r * (uint64_t)t.cum_at(sym)) & M48;
    range = r * (uint64_t)t.freq_at(sym);
    normalize();
  }
  void normalize() {
    for (;;) {
      if (((low ^ (low + range))) < TOP) {
      } else if (range < BOT) {
        range = (0 - low) & (BOT - 1);
        if (range == 0) range = BOT;
      } else {
        break;
      }
      out.push_back(uint8_t((low >> 24) & 0xFF));
      low = (low << 8) & M32;
      range = (range << 8) & M32;
    }
  }
  void finish() {
    // Minimal flush (mirrors range_coder.py::RangeEncoder.finish):
    // any v in [low, low+range) completes the stream and the decoder
    // zero-pads, so emit only the non-zero prefix of the most
    // zero-trailing v.
    uint64_t hi = low + range, v = low;
    int k = 0;
    for (int kk = 4; kk >= 1; --kk) {
      uint64_t step = 1ull << (8 * kk);
      uint64_t cand = (low + step - 1) / step * step;
      if (cand < hi) { v = cand; k = kk; break; }
    }
    v &= M32;
    for (int i = 0; i < 4 - k; ++i) {
      out.push_back(uint8_t((v >> 24) & 0xFF));
      v = (v << 8) & M32;
    }
    low = v;
  }
};

// Python floor division (rounds toward -inf) for int64.
static inline int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

struct Decoder {
  const std::vector<uint8_t>* data = nullptr;
  bool strict = false;
  size_t pos = 0;
  uint64_t low = 0, range = M32, code = 0;

  void init() {  // RangeDecoder.__init__ tail
    for (int i = 0; i < 4; ++i) code = ((code << 8) | byte_()) & M32;
  }
  int byte_() {
    uint8_t b;
    if (pos < data->size())
      b = (*data)[pos];
    else if (strict)
      throw NeedBytes{};  // pos NOT advanced (matches Python)
    else
      b = 0;  // offline decode pads past the final flush
    ++pos;
    return b;
  }
  int decode(const Table& t) {
    uint64_t r = range / (uint64_t)t.total;
    int64_t value = floordiv((int64_t)code - (int64_t)low, (int64_t)r);
    value = std::min(value, t.total - 1);
    int sym = t.find(value);
    low = (low + r * (uint64_t)t.cum_at(sym)) & M48;
    range = r * (uint64_t)t.freq_at(sym);
    normalize();
    return sym;
  }
  void normalize() {
    for (;;) {
      if (((low ^ (low + range))) < TOP) {
      } else if (range < BOT) {
        range = (0 - low) & (BOT - 1);
        if (range == 0) range = BOT;
      } else {
        break;
      }
      code = ((code << 8) | (uint64_t)byte_()) & M32;
      low = (low << 8) & M32;
      range = (range << 8) & M32;
    }
  }
};

// ---------------------------------------------------------------- walker

// mirrors range_coder._scl_split
static void scl_split(int n, int* nb_out, int* off_out) {
  int nb = (n <= 16) ? 4 : 8;
  while (nb > 1 && n % nb) nb /= 2;
  nb = std::min(nb, n);
  *nb_out = nb;
  *off_out = std::max(1, n / nb);
}

static inline int bit_length(int64_t v) {
  int b = 0;
  while (v > 0) { ++b; v >>= 1; }
  return b;
}

// mirrors range_coder._vq_ctx
static inline int vq_ctx(int prev_index, int prev_size) {
  int shift = std::max(0, bit_length(prev_size - 1) - 2);
  return std::min(VQ_CTX - 1, prev_index >> shift);
}

// mirrors range_coder._voicing_bucket
static inline int voicing_bucket(int corr_code) {
  return corr_code <= 2 ? 0 : (corr_code <= 5 ? 1 : 2);
}

// mirrors range_coder._run_bucket
static inline int run_bucket(int run) {
  return run == 0 ? 0 : bit_length(std::min<int64_t>(run, 16));
}

struct State {  // _Transcoder._st + frame counter
  int prev_p = 0, prev_c = 0, prev_i1 = 0, prev_i2 = 0;
  int run_i1 = 0, run_i2 = 0;
  int pb_scl = 0, pb_bl = 0;
  int t = 0;
};

struct Walker {
  // geometry
  int scl_n = 0, scl_bl_n = 0;
  std::vector<int> vq_entries, vq_bl_entries;
  int nb_scl = 0, off_scl = 0, nb_bl = 0, off_bl = 0;
  // value-rank permutations (empty = identity/index space)
  std::vector<int> scl_rank, scl_inv, scl_bl_rank, scl_bl_inv;

  // table arena in the canonical slot order (see native_rc.py)
  std::vector<Table> slots;
  int base_ind1 = 0, base_ind2 = 0, base_scl_b = 0, base_scl_o = 0;
  int base_bl_b = -1, base_bl_o = -1;
  int base_pabs = 0, base_pdelta = 0, base_corr = 0;
  std::vector<int> base_vq, base_vq_bl;

  bool decode_mode = false;
  Encoder enc;
  Decoder dec;
  std::vector<uint8_t> dec_buf;  // streaming decoder transport buffer
  bool dec_final = false;        // push_bytes(final=True) seen
  bool dec_ready = false;        // RangeDecoder constructed (4 bytes in)
  State st;

  // streaming rollback: lazily snapshotted tables + coder/state.
  // The undo arena is reused across frames (no allocation after the
  // first few pulls); snap_mark[slot] == snap_gen marks "already
  // backed up this frame".
  bool snapshotting = false;
  std::vector<int> snap_slots;
  std::vector<size_t> snap_off;
  std::vector<int64_t> snap_arena;
  std::vector<uint32_t> snap_mark;
  uint32_t snap_gen = 0;
  State snap_st;
  size_t snap_pos = 0;
  uint64_t snap_low = 0, snap_range = 0, snap_code = 0;

  void init_state() {
    st = State{};
    st.pb_scl = nb_scl;
    st.pb_bl = nb_bl;
  }

  int code_sym(int slot, int value) {  // _code_adaptive
    Table& t = slots[slot];
    int sym;
    if (decode_mode) {
      sym = dec.decode(t);
    } else {
      enc.encode(t, value);
      sym = value;
    }
    if (t.adaptive) {
      if (snapshotting && snap_mark[slot] != snap_gen) {
        snap_mark[slot] = snap_gen;
        snap_slots.push_back(slot);
        snap_off.push_back(snap_arena.size());
        snap_arena.insert(snap_arena.end(), t.counts.begin(),
                          t.counts.end());
      }
      t.update(sym);
    }
    return sym;
  }

  void snapshot() {
    snapshotting = true;
    if (++snap_gen == 0) {  // generation wrap: invalidate all marks
      std::fill(snap_mark.begin(), snap_mark.end(), 0u);
      snap_gen = 1;
    }
    snap_slots.clear();
    snap_off.clear();
    snap_arena.clear();
    snap_st = st;
    snap_pos = dec.pos;
    snap_low = dec.low;
    snap_range = dec.range;
    snap_code = dec.code;
  }
  void restore() {
    for (size_t i = 0; i < snap_slots.size(); ++i) {
      Table& t = slots[snap_slots[i]];
      std::copy(snap_arena.begin() + snap_off[i],
                snap_arena.begin() + snap_off[i] + t.n,
                t.counts.begin());
      t.rebuild();
    }
    st = snap_st;
    dec.pos = snap_pos;
    dec.low = snap_low;
    dec.range = snap_range;
    dec.code = snap_code;
  }

  // _chain_sym: (bucket | prev bucket) + (offset | bucket); returns rank
  int chain_sym(int base_b, int base_o, int value_rank, int prev_bucket,
                int nb, int off) {
    (void)nb;
    if (decode_mode) {
      int b = code_sym(base_b + prev_bucket, -1);
      int o = 0;
      if (off > 1) o = code_sym(base_o + b, -1);
      return b * off + o;
    }
    int r = value_rank;
    int b = r / off, o = r % off;
    code_sym(base_b + prev_bucket, b);
    if (off > 1) code_sym(base_o + b, o);
    return r;
  }

  // Transcode ONE frame; array pointers are for frame t (in encode
  // mode read, in decode mode written).  Mirrors _Transcoder.step.
  void step(int* i1_io, int* i2_io, int* iscl_io, int* iscl_bl_io,
            int* ivq_io, int* ivq_bl_io, int64_t* pcode_io) {
    const int t = st.t;
    int i1 = code_sym(
        base_ind1 + st.prev_i1 * IND_RUN_CTX + run_bucket(st.run_i1),
        decode_mode ? -1 : *i1_io);
    int i2 = code_sym(
        base_ind2 + st.prev_i2 * IND_RUN_CTX + run_bucket(st.run_i2),
        decode_mode ? -1 : *i2_io);
    st.run_i1 = (t > 0 && i1 == st.prev_i1) ? st.run_i1 + 1 : 1;
    st.run_i2 = (t > 0 && i2 == st.prev_i2) ? st.run_i2 + 1 : 1;
    if (decode_mode) { *i1_io = i1; *i2_io = i2; }
    st.prev_i1 = i1;
    st.prev_i2 = i2;

    // pitch period: delta with escape
    int p;
    if (t == 0) {
      p = code_sym(base_pabs, decode_mode ? -1 : (int)pcode_io[0]);
    } else if (decode_mode) {
      int sym = code_sym(base_pdelta + voicing_bucket(st.prev_c), -1);
      if (sym == PITCH_ESCAPE)
        p = code_sym(base_pabs, -1);
      else
        p = st.prev_p + sym - PITCH_DELTA_RANGE;
    } else {
      p = (int)pcode_io[0];
      int d = p - st.prev_p;
      int dslot = base_pdelta + voicing_bucket(st.prev_c);
      if (-PITCH_DELTA_RANGE <= d && d < PITCH_DELTA_RANGE) {
        code_sym(dslot, d + PITCH_DELTA_RANGE);
      } else {
        code_sym(dslot, PITCH_ESCAPE);
        code_sym(base_pabs, p);
      }
    }
    if (decode_mode) pcode_io[0] = p;
    st.prev_p = p;

    int c = code_sym(base_corr + st.prev_c,
                     decode_mode ? -1 : (int)pcode_io[1]);
    if (decode_mode) pcode_io[1] = c;
    st.prev_c = c;

    if (i1) {
      int r = -1;
      if (!decode_mode)
        r = scl_rank.empty() ? *iscl_io : scl_rank[*iscl_io];
      r = chain_sym(base_scl_b, base_scl_o, r, st.pb_scl, nb_scl,
                    off_scl);
      if (decode_mode)
        *iscl_io = scl_inv.empty() ? r : scl_inv[r];
      st.pb_scl = r / off_scl;
    } else if (base_bl_b >= 0) {
      int r = -1;
      if (!decode_mode)
        r = scl_bl_rank.empty() ? *iscl_bl_io
                                : scl_bl_rank[*iscl_bl_io];
      r = chain_sym(base_bl_b, base_bl_o, r, st.pb_bl, nb_bl, off_bl);
      if (decode_mode)
        *iscl_bl_io = scl_bl_inv.empty() ? r : scl_bl_inv[r];
      st.pb_bl = r / off_bl;
    }

    auto vq_stream = [&](const std::vector<int>& bases,
                         const std::vector<int>& entries, int* arr) {
      int prev_idx = 0;
      for (size_t s = 0; s < entries.size(); ++s) {
        int slot = bases[s];
        if (s > 0) slot += vq_ctx(prev_idx, entries[s - 1]);
        int v = code_sym(slot, decode_mode ? -1 : arr[s]);
        if (decode_mode) arr[s] = v;
        prev_idx = v;
      }
    };
    if (i2)
      vq_stream(base_vq, vq_entries, ivq_io);
    else
      vq_stream(base_vq_bl, vq_bl_entries, ivq_bl_io);
    ++st.t;
  }
};

Walker* make_walker(int scl_n, int scl_bl_n, int n_vq,
                    const int* vq_entries, int n_vq_bl,
                    const int* vq_bl_entries, const int* slot_n,
                    const uint8_t* slot_adaptive,
                    const int64_t* slot_counts, int n_slots,
                    const int* scl_rank, const int* scl_bl_rank,
                    int decode_mode) {
  Walker* w = new Walker();
  w->scl_n = scl_n;
  w->scl_bl_n = scl_bl_n;
  w->vq_entries.assign(vq_entries, vq_entries + n_vq);
  w->vq_bl_entries.assign(vq_bl_entries, vq_bl_entries + n_vq_bl);
  scl_split(scl_n, &w->nb_scl, &w->off_scl);
  scl_split(scl_bl_n > 0 ? scl_bl_n : 1, &w->nb_bl, &w->off_bl);
  if (scl_rank) {
    w->scl_rank.assign(scl_rank, scl_rank + scl_n);
    w->scl_inv.resize(scl_n);
    for (int i = 0; i < scl_n; ++i) w->scl_inv[w->scl_rank[i]] = i;
  }
  if (scl_bl_rank && scl_bl_n > 0) {
    w->scl_bl_rank.assign(scl_bl_rank, scl_bl_rank + scl_bl_n);
    w->scl_bl_inv.resize(scl_bl_n);
    for (int i = 0; i < scl_bl_n; ++i)
      w->scl_bl_inv[w->scl_bl_rank[i]] = i;
  }

  // canonical slot bases (mirrored by native_rc._flatten_models)
  int k = 0;
  w->base_ind1 = k; k += 2 * IND_RUN_CTX;
  w->base_ind2 = k; k += 2 * IND_RUN_CTX;
  w->base_scl_b = k; k += w->nb_scl + 1;
  w->base_scl_o = k; k += w->nb_scl;
  if (scl_bl_n > 0) {
    w->base_bl_b = k; k += w->nb_bl + 1;
    w->base_bl_o = k; k += w->nb_bl;
  }
  w->base_pabs = k; k += 1;
  w->base_pdelta = k; k += PITCH_V_CTX;
  w->base_corr = k; k += 8;
  for (int s = 0; s < n_vq; ++s) {
    w->base_vq.push_back(k);
    k += (s == 0) ? 1 : VQ_CTX;
  }
  for (int s = 0; s < n_vq_bl; ++s) {
    w->base_vq_bl.push_back(k);
    k += (s == 0) ? 1 : VQ_CTX;
  }
  if (k != n_slots) { delete w; return nullptr; }

  w->slots.resize(n_slots);
  int64_t off = 0;
  for (int i = 0; i < n_slots; ++i) {
    Table& t = w->slots[i];
    t.n = slot_n[i];
    t.adaptive = slot_adaptive[i] != 0;
    t.counts.assign(slot_counts + off, slot_counts + off + t.n);
    t.rebuild();
    off += t.n;
  }
  w->snap_mark.assign(n_slots, 0);
  w->decode_mode = decode_mode != 0;
  w->init_state();
  return w;
}

}  // namespace

// ---------------------------------------------------------------- C API

extern "C" {

void* rc_new(int scl_n, int scl_bl_n, int n_vq, const int* vq_entries,
             int n_vq_bl, const int* vq_bl_entries, const int* slot_n,
             const uint8_t* slot_adaptive, const int64_t* slot_counts,
             int n_slots, const int* scl_rank, const int* scl_bl_rank,
             int decode_mode) {
  return make_walker(scl_n, scl_bl_n, n_vq, vq_entries, n_vq_bl,
                     vq_bl_entries, slot_n, slot_adaptive, slot_counts,
                     n_slots, scl_rank, scl_bl_rank, decode_mode);
}

void rc_free(void* h) { delete static_cast<Walker*>(h); }

// Offline pack: encodes all frames, flushes, writes the body (no
// length header — the Python wrapper prepends it).  Returns the byte
// count, or -needed if out_cap is too small (caller retries).
long long rc_pack(void* h, int length, const uint8_t* ind1,
                  const uint8_t* ind2, const int* iscl,
                  const int* iscl_bl, int* ivq, int ivq_stride,
                  int* ivq_bl, int ivq_bl_stride, int64_t* pcodes,
                  uint8_t* out, long long out_cap) {
  Walker* w = static_cast<Walker*>(h);
  for (int t = 0; t < length; ++t) {
    int i1 = ind1[t], i2 = ind2[t];
    int s = iscl[t], sbl = iscl_bl[t];
    w->step(&i1, &i2, &s, &sbl, ivq + (int64_t)t * ivq_stride,
            ivq_bl + (int64_t)t * ivq_bl_stride, pcodes + 2 * t);
  }
  w->enc.finish();
  long long n = (long long)w->enc.out.size();
  if (n > out_cap) return -n;
  std::memcpy(out, w->enc.out.data(), n);
  return n;
}

// Offline unpack of a body (after the 2-byte header).
int rc_unpack(void* h, const uint8_t* data, long long data_len,
              int length, uint8_t* ind1, uint8_t* ind2, int* iscl,
              int* iscl_bl, int* ivq, int ivq_stride, int* ivq_bl,
              int ivq_bl_stride, int64_t* pcodes) {
  Walker* w = static_cast<Walker*>(h);
  w->dec_buf.assign(data, data + data_len);
  w->dec.data = &w->dec_buf;
  w->dec.strict = false;
  w->dec.init();
  for (int t = 0; t < length; ++t) {
    int i1 = 0, i2 = 0, s = -1, sbl = -1;
    w->step(&i1, &i2, &s, &sbl, ivq + (int64_t)t * ivq_stride,
            ivq_bl + (int64_t)t * ivq_bl_stride, pcodes + 2 * t);
    ind1[t] = (uint8_t)i1;
    ind2[t] = (uint8_t)i2;
    iscl[t] = s;
    iscl_bl[t] = sbl;
  }
  return 0;
}

// Streaming encoder: one frame in, newly-renormalised bytes out.
long long rc_enc_push(void* h, int i1, int i2, int iscl, int iscl_bl,
                      int* ivq, int* ivq_bl, int64_t p, int64_t c,
                      uint8_t* out, long long out_cap) {
  Walker* w = static_cast<Walker*>(h);
  size_t before = w->enc.out.size();
  int64_t pc[2] = {p, c};
  w->step(&i1, &i2, &iscl, &iscl_bl, ivq, ivq_bl, pc);
  long long n = (long long)(w->enc.out.size() - before);
  if (n > out_cap) return -n;
  std::memcpy(out, w->enc.out.data() + before, n);
  return n;
}

long long rc_enc_finish(void* h, uint8_t* out, long long out_cap) {
  Walker* w = static_cast<Walker*>(h);
  size_t before = w->enc.out.size();
  w->enc.finish();
  long long n = (long long)(w->enc.out.size() - before);
  if (n > out_cap) return -n;
  std::memcpy(out, w->enc.out.data() + before, n);
  return n;
}

// Streaming decoder transport.  rc_dec_pull returns 1 when a frame
// was decoded, 0 when more bytes are needed (state rolled back).
void rc_dec_push(void* h, const uint8_t* data, long long n, int final_) {
  Walker* w = static_cast<Walker*>(h);
  w->dec_buf.insert(w->dec_buf.end(), data, data + n);
  w->dec.data = &w->dec_buf;
  if (final_) {
    w->dec_final = true;
    w->dec.strict = false;
  }
}

// ------------------------------------------------- batched tick API
//
// Serving at scale pays ~100 us of Python/ctypes/numpy overhead PER
// STREAM per tick through the single-stream calls above (the library
// work itself is ~5 us) — one host core capped at ~85 streams while
// the chip sustains 512 per 3.15 ms tick (VALIDATION round 4).
// These entry points transcode ONE frame for EVERY stream of a bank
// in a single library call; streams are independent Walkers with
// disjoint output slices, so the loop parallelises trivially —
// n_threads > 1 splits the bank across std::threads (contiguous
// chunks; spawn cost ~20 us/thread against a 10 ms deadline).  On a
// single-core host (this dev machine) pass n_threads = 1: the win
// there is amortising the per-call overhead, measured in
// scripts/bench_streaming.py.

static void enc_many_range(void** handles, int lo, int hi,
                           const uint8_t* i1, const uint8_t* i2,
                           const int32_t* iscl, const int32_t* iscl_bl,
                           const int32_t* ivq, int ivq_stride,
                           const int32_t* ivq_bl, int ivq_bl_stride,
                           const int64_t* pc, uint8_t* out,
                           int64_t out_stride, int32_t* out_lens) {
  std::vector<int> vq_tmp, vq_bl_tmp;
  for (int i = lo; i < hi; ++i) {
    Walker* w = static_cast<Walker*>(handles[i]);
    size_t before = w->enc.out.size();
    int a = i1[i], b = i2[i], s = iscl[i], sbl = iscl_bl[i];
    // step() may write back through the vq pointers in decode mode
    // only, but take local copies anyway so the const contract of
    // the batched encode API holds
    vq_tmp.assign(ivq + (int64_t)i * ivq_stride,
                  ivq + (int64_t)i * ivq_stride + ivq_stride);
    vq_bl_tmp.assign(ivq_bl + (int64_t)i * ivq_bl_stride,
                     ivq_bl + (int64_t)i * ivq_bl_stride
                     + ivq_bl_stride);
    int64_t p2[2] = {pc[2 * i], pc[2 * i + 1]};
    w->step(&a, &b, &s, &sbl, vq_tmp.data(), vq_bl_tmp.data(), p2);
    int64_t n = (int64_t)(w->enc.out.size() - before);
    if (n > out_stride) {
      out_lens[i] = (int32_t)-n;  // overflow: report needed bytes
      continue;
    }
    std::memcpy(out + (int64_t)i * out_stride,
                w->enc.out.data() + before, n);
    out_lens[i] = (int32_t)n;
  }
}

// One encode tick for n streams.  out is (n, out_stride); out_lens[i]
// receives the chunk length (or -needed on overflow).  Returns the
// number of overflowed streams (0 = all good).
int rc_enc_push_many(void** handles, int n, const uint8_t* i1,
                     const uint8_t* i2, const int32_t* iscl,
                     const int32_t* iscl_bl, const int32_t* ivq,
                     int ivq_stride, const int32_t* ivq_bl,
                     int ivq_bl_stride, const int64_t* pc,
                     uint8_t* out, int64_t out_stride,
                     int32_t* out_lens, int n_threads) {
  if (n_threads <= 1 || n < 2 * n_threads) {
    enc_many_range(handles, 0, n, i1, i2, iscl, iscl_bl, ivq,
                   ivq_stride, ivq_bl, ivq_bl_stride, pc, out,
                   out_stride, out_lens);
  } else {
    std::vector<std::thread> ts;
    int chunk = (n + n_threads - 1) / n_threads;
    for (int k = 0; k < n_threads; ++k) {
      int lo = k * chunk, hi = std::min(n, lo + chunk);
      if (lo >= hi) break;
      ts.emplace_back(enc_many_range, handles, lo, hi, i1, i2, iscl,
                      iscl_bl, ivq, ivq_stride, ivq_bl, ivq_bl_stride,
                      pc, out, out_stride, out_lens);
    }
    for (auto& t : ts) t.join();
  }
  int bad = 0;
  for (int i = 0; i < n; ++i)
    if (out_lens[i] < 0) ++bad;
  return bad;
}

static void dec_many_range(void** handles, int lo, int hi,
                           const uint8_t* bytes, const int64_t* offs,
                           int64_t stride, const int32_t* lens,
                           int final_, int32_t* i1, int32_t* i2,
                           int32_t* iscl, int32_t* iscl_bl,
                           int32_t* ivq, int ivq_stride,
                           int32_t* ivq_bl, int ivq_bl_stride,
                           int64_t* pc, int32_t* ok) {
  for (int i = lo; i < hi; ++i) {
    Walker* w = static_cast<Walker*>(handles[i]);
    // push this stream's chunk (may be empty): either ragged
    // (offs boundaries) or strided rows (stride + lens) — the
    // encoder bank's output matrix feeds in directly in the latter
    const uint8_t* chunk;
    int64_t n_bytes;
    if (offs) {
      chunk = bytes + offs[i];
      n_bytes = offs[i + 1] - offs[i];
    } else {
      chunk = bytes + (int64_t)i * stride;
      n_bytes = lens[i];
    }
    w->dec_buf.insert(w->dec_buf.end(), chunk, chunk + n_bytes);
    w->dec.data = &w->dec_buf;
    if (final_) {
      w->dec_final = true;
      w->dec.strict = false;
    }
    // pull one frame (same rollback protocol as rc_dec_pull)
    if (!w->dec_ready) {
      if (w->dec_buf.size() < 4 && !w->dec_final) { ok[i] = 0; continue; }
      w->dec.data = &w->dec_buf;
      w->dec.strict = !w->dec_final;
      w->dec.init();
      w->dec_ready = true;
    } else {
      w->dec.strict = !w->dec_final;
    }
    i1[i] = 0; i2[i] = 0;
    iscl[i] = -1; iscl_bl[i] = -1;
    pc[2 * i] = 0; pc[2 * i + 1] = 0;
    int32_t* vq_row = ivq + (int64_t)i * ivq_stride;
    int32_t* vq_bl_row = ivq_bl + (int64_t)i * ivq_bl_stride;
    for (int s = 0; s < ivq_stride; ++s) vq_row[s] = -1;
    for (int s = 0; s < ivq_bl_stride; ++s) vq_bl_row[s] = -1;
    w->snapshot();
    try {
      int a = 0, b = 0, s = -1, sbl = -1;
      int64_t p2[2] = {0, 0};
      w->step(&a, &b, &s, &sbl, vq_row, vq_bl_row, p2);
      i1[i] = a; i2[i] = b; iscl[i] = s; iscl_bl[i] = sbl;
      pc[2 * i] = p2[0]; pc[2 * i + 1] = p2[1];
      ok[i] = 1;
    } catch (const NeedBytes&) {
      w->restore();
      ok[i] = 0;
    }
    w->snapshotting = false;
  }
}

// One receive tick for n streams: per-stream byte chunks arrive
// either concatenated in `bytes` with n+1 `offs` boundaries (pass
// stride = 0, lens = NULL), or as a strided (n, stride) matrix with
// per-row `lens` (pass offs = NULL) — the layout the encoder bank
// emits, so its output feeds the decoder with zero repacking.  One
// frame is pulled per stream (ok[i] = 1 when decoded, 0 when more
// bytes are needed — state rolled back, same as rc_dec_pull).
void rc_dec_tick_many(void** handles, int n, const uint8_t* bytes,
                      const int64_t* offs, int64_t stride,
                      const int32_t* lens, int final_, int32_t* i1,
                      int32_t* i2, int32_t* iscl, int32_t* iscl_bl,
                      int32_t* ivq, int ivq_stride, int32_t* ivq_bl,
                      int ivq_bl_stride, int64_t* pc, int32_t* ok,
                      int n_threads) {
  if (n_threads <= 1 || n < 2 * n_threads) {
    dec_many_range(handles, 0, n, bytes, offs, stride, lens, final_,
                   i1, i2, iscl, iscl_bl, ivq, ivq_stride, ivq_bl,
                   ivq_bl_stride, pc, ok);
    return;
  }
  std::vector<std::thread> ts;
  int chunk = (n + n_threads - 1) / n_threads;
  for (int k = 0; k < n_threads; ++k) {
    int lo = k * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(dec_many_range, handles, lo, hi, bytes, offs,
                    stride, lens, final_, i1, i2, iscl, iscl_bl, ivq,
                    ivq_stride, ivq_bl, ivq_bl_stride, pc, ok);
  }
  for (auto& t : ts) t.join();
}

int rc_dec_pull(void* h, int* i1, int* i2, int* iscl, int* iscl_bl,
                int* ivq, int* ivq_bl, int64_t* pcodes) {
  Walker* w = static_cast<Walker*>(h);
  if (!w->dec_ready) {
    if (w->dec_buf.size() < 4 && !w->dec_final) return 0;
    w->dec.data = &w->dec_buf;
    w->dec.strict = !w->dec_final;
    w->dec.init();
    w->dec_ready = true;
  } else {
    w->dec.strict = !w->dec_final;
  }
  *i1 = 0; *i2 = 0;
  *iscl = -1; *iscl_bl = -1;
  pcodes[0] = 0; pcodes[1] = 0;
  for (int s = 0; s < std::max((int)w->vq_entries.size(), 1); ++s)
    ivq[s] = -1;
  for (int s = 0; s < std::max((int)w->vq_bl_entries.size(), 1); ++s)
    ivq_bl[s] = -1;
  w->snapshot();
  try {
    w->step(i1, i2, iscl, iscl_bl, ivq, ivq_bl, pcodes);
  } catch (const NeedBytes&) {
    w->restore();
    w->snapshotting = false;
    return 0;
  }
  w->snapshotting = false;
  return 1;
}

}  // extern "C"
