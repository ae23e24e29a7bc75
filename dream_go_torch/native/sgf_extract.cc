// Native big-SGF example extraction for the training input pipeline (a copy
// of dream_go_tpu/native/sgf_extract.cc).
//
// C++ replacement for the reference's host-side extraction stack: the Rust
// C-ABI `extract_single_example` (src/libdg_go/utils/extract_example.rs:
// 167-225) and the TensorFlow custom op wrapper (contrib/trainer/libdg_tf/
// sgf_to_features.cc).  Board replay and feature extraction stay on the
// device (PyTorch); this library handles what the host must do per line: parse the SGF,
// decode b85 policy blobs, pick a training position with the value-weighted
// distribution, and assemble labels.  Exposed over a plain C ABI consumed
// via ctypes.
//
// Semantics parity:
// - value-weighted position choice favouring |v-0.5| small, policy-carrying
//   positions preferred (extract_example.rs:235-266)
// - scored games get their missing final passes appended (:199-214); games
//   shorter than 30 moves are rejected (:216-219)
// - policy label = P[] blob + residual mass at the played move, else one-hot
//   (sgf_to_features.cc:240-241)
// - winner +-1 relative to the color to move; ownership +-1 from TB/TW
//   relative to the color to move (extract_example.rs:329-371)

#include <cstdint>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>

namespace {

constexpr int kBoard = 361;
constexpr int kPass = 361;
constexpr int kPolicy = 362;
constexpr int kMaxMoves = 1024;

// -- xorshift RNG (seeded per call; parity with set_seed determinism) -------
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9E3779B97F4A7C15ull) {}
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

// -- base85 (RFC-1924 alphabet, 4-byte big-endian groups; utils/b85.py) -----
int b85_value(char c) {
  static int table[256];
  static bool init = false;
  if (!init) {
    const char* alphabet =
        "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        "abcdefghijklmnopqrstuvwxyz!#$%&()*+-;<=>?@^_`{|}~";
    for (int i = 0; i < 256; ++i) table[i] = -1;
    for (int i = 0; alphabet[i]; ++i)
      table[static_cast<unsigned char>(alphabet[i])] = i;
    init = true;
  }
  return table[static_cast<unsigned char>(c)];
}

float half_to_float(uint16_t h) {
  uint32_t sign = (h >> 15) & 1, exp = (h >> 10) & 0x1F, frac = h & 0x3FF;
  uint32_t f;
  if (exp == 0) {
    if (frac == 0) {
      f = sign << 31;
    } else {
      exp = 127 - 15 + 1;
      while (!(frac & 0x400)) {
        frac <<= 1;
        --exp;
      }
      frac &= 0x3FF;
      f = (sign << 31) | (exp << 23) | (frac << 13);
    }
  } else if (exp == 31) {
    f = (sign << 31) | 0x7F800000u | (frac << 13);
  } else {
    f = (sign << 31) | ((exp - 15 + 127) << 23) | (frac << 13);
  }
  float out;
  std::memcpy(&out, &f, 4);
  return out;
}

// decode a b85 blob of 362 f16 values; returns false on malformed input
bool decode_policy_b85(const char* s, size_t len, float* out362) {
  std::vector<uint8_t> bytes;
  bytes.reserve(len * 4 / 5 + 4);
  size_t i = 0;
  while (i + 5 <= len) {
    uint32_t acc = 0;
    for (int k = 0; k < 5; ++k) {
      int v = b85_value(s[i + k]);
      if (v < 0) return false;
      acc = acc * 85 + static_cast<uint32_t>(v);
    }
    bytes.push_back((acc >> 24) & 0xFF);
    bytes.push_back((acc >> 16) & 0xFF);
    bytes.push_back((acc >> 8) & 0xFF);
    bytes.push_back(acc & 0xFF);
    i += 5;
  }
  if (bytes.size() < kPolicy * 2) return false;
  for (int j = 0; j < kPolicy; ++j) {
    uint16_t h = static_cast<uint16_t>(bytes[2 * j]) |
                 (static_cast<uint16_t>(bytes[2 * j + 1]) << 8);
    out362[j] = half_to_float(h);
  }
  return true;
}

// -- SGF scanning -----------------------------------------------------------
int sgf_point(const char* v, size_t n) {
  if (n == 0) return kPass;
  if (n != 2) return -1;
  int x = v[0] - 'a', y = v[1] - 'a';
  if (x == 19 && y == 19) return kPass;  // "tt"
  if (x < 0 || x >= 19 || y < 0 || y >= 19) return -1;
  return 19 * y + x;
}

struct Move {
  int color;  // 1 black / 2 white
  int point;
  float value;  // to-move winrate [0,1], NaN absent
  std::vector<float> policy;  // empty or 362
};

struct Game {
  float komi = 7.5f;
  int winner = 0;
  bool scored = false;
  std::vector<Move> moves;
  int8_t ownership[kBoard];  // 0/1/2 absolute colors
  Game() { std::memset(ownership, 0, sizeof(ownership)); }
};

// find "XX[" at a property boundary; returns value span
bool prop_value(const std::string& s, size_t from, const char* name,
                size_t* start, size_t* end) {
  size_t pos = s.find(std::string(name) + "[", from);
  if (pos == std::string::npos) return false;
  size_t open = pos + std::strlen(name);
  size_t close = s.find(']', open + 1);
  if (close == std::string::npos) return false;
  *start = open + 1;
  *end = close;
  return true;
}

bool parse_game(const std::string& line, Game* g) {
  size_t a, b;
  if (prop_value(line, 0, "KM", &a, &b))
    g->komi = std::strtof(line.c_str() + a, nullptr);
  if (prop_value(line, 0, "RE", &a, &b)) {
    if (line[a] == 'B') g->winner = 1;
    if (line[a] == 'W') g->winner = 2;
    size_t plus = line.find('+', a);
    if (plus != std::string::npos && plus < b) {
      char c = line[plus + 1];
      g->scored = (c >= '0' && c <= '9');
    }
  }

  // moves: scan for ";B[" / ";W[" outside property values
  bool in_prop = false;
  for (size_t i = 0; i + 2 < line.size(); ++i) {
    char c = line[i];
    if (in_prop) {
      if (c == ']') in_prop = false;
      continue;
    }
    if (c == '[') {
      in_prop = true;
      continue;
    }
    if (c != ';') continue;
    size_t j = i + 1;
    while (j < line.size() && std::isspace(static_cast<unsigned char>(line[j])))
      ++j;
    if (j >= line.size() || (line[j] != 'B' && line[j] != 'W') ||
        j + 1 >= line.size() || line[j + 1] != '[')
      continue;
    size_t close = line.find(']', j + 2);
    if (close == std::string::npos) return false;
    Move m;
    m.color = line[j] == 'B' ? 1 : 2;
    m.point = sgf_point(line.c_str() + j + 2, close - (j + 2));
    if (m.point < 0) return false;
    m.value = NAN;

    // annotations up to the next move node
    size_t anno_end = line.size();
    {
      bool ip = false;
      for (size_t k = close + 1; k + 2 < line.size(); ++k) {
        if (ip) {
          if (line[k] == ']') ip = false;
          continue;
        }
        if (line[k] == '[') {
          ip = true;
          continue;
        }
        if (line[k] == ';') {
          anno_end = k;
          break;
        }
      }
    }
    std::string anno = line.substr(close + 1, anno_end - close - 1);
    size_t va, vb;
    if (prop_value(anno, 0, "V", &va, &vb)) {
      float black_v = std::strtof(anno.c_str() + va, nullptr);
      float wr = (black_v + 1.0f) / 2.0f;
      m.value = m.color == 1 ? wr : 1.0f - wr;
    }
    size_t pa, pb;
    if (prop_value(anno, 0, "P", &pa, &pb)) {
      m.policy.resize(kPolicy);
      if (!decode_policy_b85(anno.c_str() + pa, pb - pa, m.policy.data()))
        m.policy.clear();
    }
    g->moves.push_back(std::move(m));
    i = close;
  }

  // territory: TB/TW sequences of [xy]
  for (int color = 1; color <= 2; ++color) {
    const char* name = color == 1 ? "TB" : "TW";
    size_t pos = line.find(name);
    while (pos != std::string::npos) {
      // require property boundary: previous char not a letter
      if (pos > 0 && std::isalpha(static_cast<unsigned char>(line[pos - 1]))) {
        pos = line.find(name, pos + 1);
        continue;
      }
      size_t k = pos + 2;
      bool any = false;
      while (k + 3 < line.size() && line[k] == '[' && line[k + 3] == ']') {
        int p = sgf_point(line.c_str() + k + 1, 2);
        if (p >= 0 && p < kBoard) g->ownership[p] = color;
        k += 4;
        any = true;
      }
      if (any) break;
      pos = line.find(name, pos + 1);
    }
  }
  return !g->moves.empty();
}

}  // namespace

extern "C" {

struct ExtractedExample {
  int32_t num_moves;
  int32_t target;
  int32_t color;
  float komi;
  float value;
  float has_ownership;
  int32_t moves[kMaxMoves];
  float policy[kPolicy];
  float ownership[kBoard];
};

// Returns 0 on success, negative error codes like the reference
// (-23 parse error, -31 too short).
int extract_single_example(const char* line_c, uint64_t seed,
                           ExtractedExample* out) {
  std::string line(line_c);
  Game g;
  if (!parse_game(line, &g)) return -23;

  // append missing final passes on scored games
  int pass_count = 0;
  for (const Move& m : g.moves)
    pass_count = m.point == kPass ? pass_count + 1 : 0;
  while (g.scored && pass_count < 2 &&
         g.moves.size() < static_cast<size_t>(kMaxMoves)) {
    Move m;
    m.color = g.moves.empty() ? 1 : 3 - g.moves.back().color;
    m.point = kPass;
    m.value = NAN;
    g.moves.push_back(std::move(m));
    ++pass_count;
  }
  if (g.moves.size() < 30) return -31;
  if (g.moves.size() > static_cast<size_t>(kMaxMoves)) return -23;

  // value-weighted position choice; policy-carrying positions preferred
  bool has_policy = false;
  for (const Move& m : g.moves) has_policy |= !m.policy.empty();
  std::vector<int> cand;
  std::vector<double> cum;
  double so_far = 0.0;
  for (size_t i = 0; i < g.moves.size(); ++i) {
    if (has_policy && g.moves[i].policy.empty()) continue;
    float v = g.moves[i].value;
    double w = std::isnan(v) ? 0.5 : 0.6 - std::fabs(v - 0.5);
    if (w < 1e-6) w = 1e-6;
    so_far += w;
    cand.push_back(static_cast<int>(i));
    cum.push_back(so_far);
  }
  if (cand.empty()) return -32;
  Rng rng(seed);
  double pick = rng.uniform() * so_far;
  size_t lo = 0;
  while (lo + 1 < cum.size() && cum[lo] < pick) ++lo;
  int idx = cand[lo];

  const Move& chosen = g.moves[idx];
  out->num_moves = static_cast<int32_t>(g.moves.size());
  out->target = idx;
  out->color = chosen.color;
  out->komi = g.komi;
  for (size_t i = 0; i < g.moves.size(); ++i)
    out->moves[i] = g.moves[i].point;
  for (size_t i = g.moves.size(); i < kMaxMoves; ++i) out->moves[i] = kPass;

  std::memset(out->policy, 0, sizeof(out->policy));
  float total = 0.0f;
  if (!chosen.policy.empty()) {
    for (int i = 0; i < kPolicy; ++i) {
      float p = chosen.policy[i];
      if (std::isfinite(p) && p > 0) {
        out->policy[i] = p;
        total += p;
      }
    }
  }
  if (total > 1.0f) {  // renormalize slightly-overflowing f16 sums
    for (int i = 0; i < kPolicy; ++i) out->policy[i] /= total;
    total = 1.0f;
  }
  out->policy[chosen.point] += 1.0f - total;

  out->value = g.winner == 0 ? 0.0f : (g.winner == chosen.color ? 1.0f : -1.0f);

  float any_own = 0.0f;
  for (int i = 0; i < kBoard; ++i) {
    int8_t o = g.ownership[i];
    out->ownership[i] =
        o == 0 ? 0.0f : (o == chosen.color ? 1.0f : -1.0f);
    if (o) any_own = 1.0f;
  }
  out->has_ownership = any_own;
  return 0;
}

int extract_batch(const char** lines, int n, uint64_t seed,
                  ExtractedExample* out) {
  int ok = 0;
  for (int i = 0; i < n; ++i) {
    int rc = extract_single_example(lines[i], seed + 0x9E37u * (i + 1),
                                    &out[i]);
    if (rc == 0)
      ++ok;
    else
      out[i].num_moves = 0;  // num_moves==0 marks failure
  }
  return ok;
}

int dg_native_abi_version() { return 1; }
}
