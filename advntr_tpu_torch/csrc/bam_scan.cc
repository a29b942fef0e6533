// Walk of a BAM's inflated records for recruitment's unmapped pass.
//
// The record loop of advntr_tpu_torch/io/bam_scan.py: records are walked by
// their block_size fields, each record's flag is read first, and only the
// records with flag bit 4 set (unmapped) go further: their name (less its
// NUL) and their packed 4-bit bases are copied out, laid end to end with
// row offsets.  The CIGAR and the qualities are never read.  The per-record
// Python parse it replaces (io/bam.py::_parse_record) decodes every base of
// every record in an interpreter loop.

#include <cstdint>
#include <cstring>

namespace {

int32_t read_i32(const uint8_t* p) {
    int32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

uint16_t read_u16(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return v;
}

// bytes of a record's fixed fields after its block_size
constexpr int64_t kFixed = 32;

}  // namespace

extern "C" {

// Walks the whole records at the head of buf[0, n).  Writes the unmapped
// records' names and packed bases into names and packed (each needs at
// most n bytes), their offsets into name_off and seq_off (rows + 1 entries;
// rows is at most n / 36) and their lengths in bases into lengths.
// out[0]: records walked, out[1]: unmapped rows, out[2]: bytes consumed
// (the start of the first record not wholly in the buffer).
// Returns 0, or -1 where a record is malformed: a block_size under 32, or
// its name, CIGAR, bases or qualities past the record's end.
int bam_scan_chunk(const uint8_t* buf, int64_t n, uint8_t* names,
                   int64_t* name_off, uint8_t* packed, int64_t* seq_off,
                   int32_t* lengths, int64_t* out) {
    int64_t off = 0, walked = 0, rows = 0;
    name_off[0] = 0;
    seq_off[0] = 0;
    while (off + 4 + kFixed <= n) {
        const int64_t size = read_i32(buf + off);
        if (size < kFixed) return -1;
        const int64_t end = off + 4 + size;
        if (end > n) break;
        const uint8_t* rec = buf + off + 4;
        if (read_u16(rec + 14) & 4) {
            const int64_t l_name = rec[8];
            const int64_t n_cigar = read_u16(rec + 12);
            const int64_t l_seq = read_i32(rec + 16);
            const int64_t nbytes = (l_seq + 1) / 2;
            const int64_t seq_at = kFixed + l_name + 4 * n_cigar;
            if (l_name < 1 || l_seq < 0 || seq_at + nbytes + l_seq > size)
                return -1;
            std::memcpy(names + name_off[rows], rec + kFixed, l_name - 1);
            name_off[rows + 1] = name_off[rows] + l_name - 1;
            std::memcpy(packed + seq_off[rows], rec + seq_at, nbytes);
            seq_off[rows + 1] = seq_off[rows] + nbytes;
            lengths[rows] = static_cast<int32_t>(l_seq);
            ++rows;
        }
        ++walked;
        off = end;
    }
    out[0] = walked;
    out[1] = rows;
    out[2] = off;
    return 0;
}

}  // extern "C"
