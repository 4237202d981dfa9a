// Columnar BAM record decoder of lancet2_tpu_torch, built with g++ alone.
//
// The C ABI that lancet2_tpu_torch/hts/native.py loads with ctypes: record
// counting and single-pass parsing of an inflated BAM records region into
// columnar arrays (struct-of-arrays) that numpy wraps, batch qname hashing,
// and the active-region event scan. It needs no third-party header and
// links no library: the caller inflates the BGZF blocks (Python's zlib) and
// hands over the BAM bytes. Copied from the repo's native/bam_decoder.cpp
// without its libdeflate inflation.

#include <cstdint>
#include <cstring>

extern "C" {

// Count BAM alignment records in the records region [off, size).
int64_t l2t_bam_count(const uint8_t* data, size_t size, size_t off) {
  int64_t count = 0;
  while (off + 4 <= size) {
    int32_t block_size;
    std::memcpy(&block_size, data + off, 4);
    if (block_size < 32 || off + 4 + static_cast<size_t>(block_size) > size) break;
    off += 4 + static_cast<size_t>(block_size);
    ++count;
  }
  return count;
}

static const char NIBBLE_BASES[17] = "=ACMGRSVTWYHKDBN";

// Parse the records region into columnar arrays (all preallocated by the
// caller with sizes from l2t_bam_count / the raw buffer size).
//
// Fixed-width outputs (length n):
//   ref_id, pos, next_ref_id, next_pos, tlen : int32
//   flag : uint16   mapq : uint8   l_seq : int32  n_cigar : uint16
//   qname_off, cigar_off, seq_off, aux_off : int64 (offsets into pools)
//   qname_len : uint8    aux_len : int32
// Pools (caller sizes them at `size` bytes / 4-byte units, generous):
//   qname_pool : bytes   cigar_pool : uint32   seq_pool : ASCII bases
//   qual_pool  : bytes (same offsets as seq)   aux_pool : raw bytes
// Returns number of records parsed, or negative on error.
int64_t l2t_bam_parse(const uint8_t* data, size_t size, size_t off, int64_t n,
                      int32_t* ref_id, int32_t* pos, int32_t* next_ref_id,
                      int32_t* next_pos, int32_t* tlen, uint16_t* flag,
                      uint8_t* mapq, int32_t* l_seq_arr, uint16_t* n_cigar_arr,
                      int64_t* qname_off, uint8_t* qname_len,
                      int64_t* cigar_off, int64_t* seq_off, int64_t* aux_off,
                      int32_t* aux_len, uint8_t* qname_pool,
                      uint32_t* cigar_pool, uint8_t* seq_pool,
                      uint8_t* qual_pool, uint8_t* aux_pool) {
  int64_t idx = 0;
  size_t qn_cur = 0, cg_cur = 0, sq_cur = 0, ax_cur = 0;
  while (off + 4 <= size && idx < n) {
    int32_t block_size;
    std::memcpy(&block_size, data + off, 4);
    if (block_size < 32 || off + 4 + static_cast<size_t>(block_size) > size)
      break;
    const uint8_t* rec = data + off + 4;
    int32_t rid, p, ls, nref, npos, tl;
    uint8_t lrn, mq;
    uint16_t ncig, flg;
    std::memcpy(&rid, rec, 4);
    std::memcpy(&p, rec + 4, 4);
    lrn = rec[8];
    mq = rec[9];
    std::memcpy(&ncig, rec + 12, 2);
    std::memcpy(&flg, rec + 14, 2);
    std::memcpy(&ls, rec + 16, 4);
    std::memcpy(&nref, rec + 20, 4);
    std::memcpy(&npos, rec + 24, 4);
    std::memcpy(&tl, rec + 28, 4);

    ref_id[idx] = rid;
    pos[idx] = p;
    next_ref_id[idx] = nref;
    next_pos[idx] = npos;
    tlen[idx] = tl;
    flag[idx] = flg;
    mapq[idx] = mq;
    l_seq_arr[idx] = ls;
    n_cigar_arr[idx] = ncig;

    const uint8_t* cursor = rec + 32;
    // qname (drop trailing NUL)
    qname_off[idx] = static_cast<int64_t>(qn_cur);
    qname_len[idx] = lrn > 0 ? static_cast<uint8_t>(lrn - 1) : 0;
    std::memcpy(qname_pool + qn_cur, cursor, lrn > 0 ? lrn - 1 : 0);
    qn_cur += lrn > 0 ? lrn - 1 : 0;
    cursor += lrn;
    // cigar
    cigar_off[idx] = static_cast<int64_t>(cg_cur);
    std::memcpy(cigar_pool + cg_cur, cursor, static_cast<size_t>(ncig) * 4);
    cg_cur += ncig;
    cursor += static_cast<size_t>(ncig) * 4;
    // seq: unpack nibbles to ASCII
    seq_off[idx] = static_cast<int64_t>(sq_cur);
    {
      const uint8_t* packed = cursor;
      for (int32_t i = 0; i < ls; ++i) {
        uint8_t nib = (i & 1) ? (packed[i >> 1] & 0x0F) : (packed[i >> 1] >> 4);
        seq_pool[sq_cur + static_cast<size_t>(i)] =
            static_cast<uint8_t>(NIBBLE_BASES[nib]);
      }
    }
    cursor += (ls + 1) / 2;
    // qual (parallel to seq offsets)
    std::memcpy(qual_pool + sq_cur, cursor, static_cast<size_t>(ls));
    sq_cur += static_cast<size_t>(ls);
    cursor += ls;
    // aux: raw copy
    const uint8_t* rec_end = rec + block_size;
    size_t alen = static_cast<size_t>(rec_end - cursor);
    aux_off[idx] = static_cast<int64_t>(ax_cur);
    aux_len[idx] = static_cast<int32_t>(alen);
    std::memcpy(aux_pool + ax_cur, cursor, alen);
    ax_cur += alen;

    off += 4 + static_cast<size_t>(block_size);
    ++idx;
  }
  return idx;
}

// Batch FNV-1a-64 + splitmix64 avalanche over pool slices — bit-identical
// to lancet2_tpu_torch/base/hashing.py::hash_str64 (used for read-qname identity:
// MateMer dedup + deterministic downsampling).
void l2t_hash_batch(const uint8_t* pool, const int64_t* offs,
                    const int64_t* lens, int64_t n, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = pool + offs[i];
    const int64_t len = lens[i];
    uint64_t h = 0xCBF29CE484222325ull;
    for (int64_t j = 0; j < len; ++j)
      h = (h ^ p[j]) * 0x100000001B3ull;
    h ^= h >> 30;
    h *= 0xBF58476D1CE4E5B9ull;
    h ^= h >> 27;
    h *= 0x94D049BB133111EBull;
    h ^= h >> 31;
    out[i] = h;
  }
}

// Active-region mutation-event scan over the columnar arrays: for every
// record emit (genome_pos, kind) events — kind 0=mismatch (MD + X CIGAR),
// 1=insertion, 2=deletion, 3=softclip — matching
// lancet2_tpu_torch/core/active_region.py::_record_events exactly (reference:
// src/lancet/core/active_region_detector.cpp). Records failing
// QC/dup/unmapped/MAPQ==0 emit nothing. ev_off[i]..ev_off[i+1] spans record
// i's events in file order. Returns the TOTAL event count (which may exceed
// `cap`; events beyond cap are counted but not written — caller reallocates
// and calls again).
int64_t l2t_event_scan(int64_t n, const int32_t* pos, const uint16_t* flag,
                       const uint8_t* mapq, const uint16_t* n_cigar,
                       const int64_t* cigar_off, const uint32_t* cigar_pool,
                       const int32_t* l_seq, const int64_t* seq_off,
                       const uint8_t* qual_pool, const int64_t* aux_off,
                       const int32_t* aux_len, const uint8_t* aux_pool,
                       int64_t cap, int64_t* ev_pos, uint8_t* ev_kind,
                       int64_t* ev_off) {
  constexpr uint16_t kSkipFlags = 0x200 | 0x400 | 0x4;  // qcfail|dup|unmapped
  constexpr uint8_t kMinBaseQual = 20;
  int64_t total = 0;
  ev_off[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    if ((flag[i] & kSkipFlags) != 0 || mapq[i] == 0) {
      ev_off[i + 1] = total;
      continue;
    }
    const int64_t start0 = pos[i];
    const int32_t ls = l_seq[i];
    const uint8_t* quals = qual_pool + seq_off[i];
    auto emit = [&](int64_t p, uint8_t kind) {
      if (total < cap) {
        ev_pos[total] = p;
        ev_kind[total] = kind;
      }
      ++total;
    };
    // ---- MD:Z tag mismatches -----------------------------------------
    const uint8_t* aux = aux_pool + aux_off[i];
    const uint8_t* aux_end = aux + aux_len[i];
    const uint8_t* md = nullptr;
    const uint8_t* cur = aux;
    while (cur + 3 <= aux_end) {
      const uint8_t t0 = cur[0], t1 = cur[1], typ = cur[2];
      const uint8_t* val = cur + 3;
      size_t vlen = 0;
      switch (typ) {
        case 'A': case 'c': case 'C': vlen = 1; break;
        case 's': case 'S': vlen = 2; break;
        case 'i': case 'I': case 'f': vlen = 4; break;
        case 'Z': case 'H': {
          const uint8_t* z = val;
          while (z < aux_end && *z != 0) ++z;
          vlen = static_cast<size_t>(z - val) + 1;
          break;
        }
        case 'B': {
          if (val + 5 > aux_end) { cur = aux_end; continue; }
          uint8_t sub = val[0];
          uint32_t count;
          std::memcpy(&count, val + 1, 4);
          size_t esz = (sub == 'c' || sub == 'C') ? 1
                       : (sub == 's' || sub == 'S') ? 2 : 4;
          vlen = 5 + static_cast<size_t>(count) * esz;
          break;
        }
        default: cur = aux_end; continue;  // unknown type: stop
      }
      if (t0 == 'M' && t1 == 'D' && typ == 'Z') {
        md = val;
        break;
      }
      cur = val + vlen;
    }
    if (md != nullptr) {
      int64_t genome_pos = start0;
      int64_t token = 0;
      bool have_token = false;
      const uint8_t* z = md;
      while (*z != 0 && z < aux_end) {
        const uint8_t ch = *z;
        if (ch >= '0' && ch <= '9') {
          token = token * 10 + (ch - '0');
          have_token = true;
          ++z;
          continue;
        }
        if (have_token) genome_pos += token;
        token = 0;
        have_token = false;
        if (ch == '^') {
          ++z;
          while (*z != 0 && z < aux_end &&
                 ((*z >= 'A' && *z <= 'Z') || (*z >= 'a' && *z <= 'z'))) {
            ++z;
            ++genome_pos;
          }
          continue;
        }
        const int64_t base_pos = genome_pos - start0;
        if (base_pos >= 0 && base_pos < ls && quals[base_pos] >= kMinBaseQual) {
          const uint8_t up = (ch >= 'a') ? ch - 32 : ch;
          if (up == 'A' || up == 'C' || up == 'G' || up == 'T')
            emit(genome_pos, 0);
        }
        ++genome_pos;
        ++z;
      }
    }
    // ---- CIGAR I/D/X events ------------------------------------------
    const uint32_t* cig = cigar_pool + cigar_off[i];
    const int nc = n_cigar[i];
    int64_t gpos = start0;
    for (int c = 0; c < nc; ++c) {
      const uint32_t op = cig[c] & 0xF;
      const uint32_t len = cig[c] >> 4;
      // ref-consuming: M(0) D(2) N(3) =(7) X(8)
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) gpos += len;
      if (op == 1) emit(gpos, 1);
      else if (op == 2) emit(gpos, 2);
      else if (op == 8) emit(gpos, 0);
    }
    // ---- soft-clip ends ----------------------------------------------
    if (nc > 0) {
      if ((cig[0] & 0xF) == 4) emit(start0, 3);
      if (nc > 1 && (cig[nc - 1] & 0xF) == 4) emit(gpos, 3);
    }
    ev_off[i + 1] = total;
  }
  return total;
}

}  // extern "C"
