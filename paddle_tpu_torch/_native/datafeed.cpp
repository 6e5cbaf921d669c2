// MultiSlot text-format parser — the hot loop of the Dataset ingestion
// path.
//
// Reference parity: paddle/fluid/framework/data_feed.cc
// (MultiSlotDataFeed::ParseOneInstance) — each line is one instance; for
// each slot in declared order: a count token followed by that many value
// tokens (int64 ids for sparse slots, float32 for dense slots).
//
// The port's own copy of paddle_tpu/_native/datafeed.cpp, exposed as a C
// interface reached through ctypes (as shm_ring.cpp).
// Two-pass use: call with null pools to size, then with buffers to fill.
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Returns the number of instances parsed, or -(1 + byte_offset) on a
// malformed line. counts[inst * n_slots + s] = value count of slot s.
// When ints/floats are null the pass only tallies: *total_ints /
// *total_floats / return value are still filled (counts too when
// non-null). slot_is_float[s]: 1 -> float32 slot, 0 -> int64 slot.
long long pt_multislot_parse(const char* buf, long long len,
                             const int* slot_is_float, int n_slots,
                             long long* counts, long long counts_cap,
                             long long* ints, long long ints_cap,
                             float* floats, long long floats_cap,
                             long long* total_ints,
                             long long* total_floats) {
  long long pos = 0, n_inst = 0, n_int = 0, n_float = 0;
  while (pos < len) {
    // skip blank lines
    while (pos < len && (buf[pos] == '\n' || buf[pos] == '\r')) pos++;
    if (pos >= len) break;
    for (int s = 0; s < n_slots; s++) {
      // parse the count token; '\r' = truncated CRLF line, and '\f'/'\v'
      // would be silently eaten by strtoll's own isspace() skip (possibly
      // across the newline) — all are malformed here
      while (pos < len && (buf[pos] == ' ' || buf[pos] == '\t')) pos++;
      if (pos >= len || buf[pos] == '\n' || buf[pos] == '\r' ||
          buf[pos] == '\f' || buf[pos] == '\v')
        return -(1 + pos);
      char* end = nullptr;
      long long cnt = strtoll(buf + pos, &end, 10);
      if (end == buf + pos || cnt < 0) return -(1 + pos);
      pos = end - buf;
      if (counts) {
        if (n_inst * n_slots + s >= counts_cap) return -(1 + pos);
        counts[n_inst * n_slots + s] = cnt;
      }
      for (long long v = 0; v < cnt; v++) {
        while (pos < len && (buf[pos] == ' ' || buf[pos] == '\t')) pos++;
        if (pos >= len || buf[pos] == '\n' || buf[pos] == '\r' ||
            buf[pos] == '\f' || buf[pos] == '\v')
          return -(1 + pos);
        if (slot_is_float[s]) {
          float val = strtof(buf + pos, &end);
          if (end == buf + pos) return -(1 + pos);
          if (floats) {
            if (n_float >= floats_cap) return -(1 + pos);
            floats[n_float] = val;
          }
          n_float++;
        } else {
          long long val = strtoll(buf + pos, &end, 10);
          if (end == buf + pos) return -(1 + pos);
          if (ints) {
            if (n_int >= ints_cap) return -(1 + pos);
            ints[n_int] = val;
          }
          n_int++;
        }
        pos = end - buf;
      }
    }
    // consume to end of line
    while (pos < len && buf[pos] != '\n') {
      if (buf[pos] != ' ' && buf[pos] != '\t' && buf[pos] != '\r')
        return -(1 + pos);  // trailing garbage = malformed instance
      pos++;
    }
    n_inst++;
  }
  if (total_ints) *total_ints = n_int;
  if (total_floats) *total_floats = n_float;
  return n_inst;
}

}  // extern "C"
