// Native raw-accelerometer stream parser (WISDM v1.1 raw text format).
//
// The reference trains on the *pre-transformed* WISDM CSV (SURVEY §2 S); the
// transform's input is the raw stream `WISDM_ar_v1.1_raw.txt`, records of
// the form `user,activity,timestamp,x,y,z;` separated by ';' and/or
// newlines.  The neural configs in BASELINE.json consume raw windows, so
// ingesting this format fast is a real hot path: this library memory-loads
// the file, splits it into chunks parsed on worker threads, and emits
// columnar arrays (int32 user, int32 activity id + vocabulary, int64
// timestamp, float32 x/y/z) ready for host-side windowing
// (har_tpu.data.raw_windows) and the jitted on-device featurizer
// (har_tpu.features.raw_features).
//
// Malformed records (wrong field count, unparsable numbers — the public
// file has a handful) are counted and skipped, matching the tolerant
// behavior of published WISDM preprocessing scripts.
//
// C ABI only (ctypes; no pybind11 in this image).  Build:
//   g++ -O2 -std=c++17 -shared -fPIC -pthread rawloader.cpp -o libharraw.so

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ChunkOut {
  std::vector<int32_t> user;
  std::vector<int32_t> activity;          // index into local_names
  std::vector<std::string> local_names;   // first-appearance order
  std::vector<int64_t> timestamp;
  std::vector<float> x, y, z;
  int64_t skipped = 0;
};

// Field parsers match Python's int()/float() tolerance: surrounding
// whitespace is accepted, and float underflow/overflow (errno=ERANGE from
// strtof on subnormals like 1e-42) is NOT an error — Python returns the
// denormal/inf, so we keep strtof's value and only reject trailing junk.
void trim(const char** b, const char** e) {
  while (*b < *e && (**b == ' ' || **b == '\t' || **b == '\r')) ++*b;
  while (*e > *b && ((*e)[-1] == ' ' || (*e)[-1] == '\t' ||
                     (*e)[-1] == '\r'))
    --*e;
}

bool parse_ll(const char* b, const char* e, long long* out) {
  trim(&b, &e);
  if (b >= e) return false;
  errno = 0;
  char* endp = nullptr;
  std::string s(b, e);
  long long v = strtoll(s.c_str(), &endp, 10);
  if (errno || endp != s.c_str() + s.size()) return false;
  *out = v;
  return true;
}

bool parse_f(const char* b, const char* e, float* out) {
  trim(&b, &e);
  if (b >= e) return false;
  char* endp = nullptr;
  std::string s(b, e);
  float v = strtof(s.c_str(), &endp);
  if (endp != s.c_str() + s.size()) return false;
  *out = v;
  return true;
}

// Parse records in [begin, end); records are terminated by ';' or '\n'.
void parse_chunk(const char* begin, const char* end, ChunkOut* out) {
  std::map<std::string, int32_t> vocab;
  const char* p = begin;
  while (p < end) {
    // find record terminator
    const char* q = p;
    while (q < end && *q != ';' && *q != '\n') ++q;
    // trim whitespace
    const char* rb = p;
    const char* re = q;
    while (rb < re && (*rb == ' ' || *rb == '\r' || *rb == '\t')) ++rb;
    while (re > rb && (re[-1] == ' ' || re[-1] == '\r' || re[-1] == '\t'))
      --re;
    if (re > rb) {
      // split on commas into exactly 6 fields
      const char* f[7];
      int nf = 0;
      f[nf++] = rb;
      for (const char* c = rb; c < re && nf < 7; ++c)
        if (*c == ',') f[nf++] = c + 1;
      long long uid, ts;
      float fx, fy, fz;
      if (nf == 6 &&
          parse_ll(f[0], f[1] - 1, &uid) &&
          parse_ll(f[2], f[3] - 1, &ts) &&
          parse_f(f[3], f[4] - 1, &fx) &&
          parse_f(f[4], f[5] - 1, &fy) &&
          parse_f(f[5], re, &fz)) {
        std::string act(f[1], f[2] - 1);
        auto it = vocab.find(act);
        int32_t id;
        if (it == vocab.end()) {
          id = static_cast<int32_t>(out->local_names.size());
          vocab.emplace(std::move(act), id);
          out->local_names.push_back(std::string(f[1], f[2] - 1));
        } else {
          id = it->second;
        }
        out->user.push_back(static_cast<int32_t>(uid));
        out->activity.push_back(id);
        out->timestamp.push_back(static_cast<int64_t>(ts));
        out->x.push_back(fx);
        out->y.push_back(fy);
        out->z.push_back(fz);
      } else {
        ++out->skipped;
      }
    }
    p = q + 1;
  }
}

struct RawTable {
  std::vector<int32_t> user;
  std::vector<int32_t> activity;
  std::vector<std::string> names;  // global vocab, first-appearance order
  std::vector<int64_t> timestamp;
  std::vector<float> x, y, z;
  int64_t skipped = 0;
  std::string error;
};

}  // namespace

extern "C" {

RawTable* raw_load(const char* path, int num_threads) {
  auto table = std::make_unique<RawTable>();
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) {
    table->error = std::string("cannot open ") + path;
    return table.release();
  }
  std::streamsize size = f.tellg();
  f.seekg(0);
  std::string buf(static_cast<size_t>(size), '\0');
  if (size > 0 && !f.read(buf.data(), size)) {
    table->error = "read failed";
    return table.release();
  }

  int nthreads = num_threads > 0
      ? num_threads
      : static_cast<int>(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;

  // chunk on record terminators so no record straddles a boundary
  const char* data = buf.data();
  const char* end = data + buf.size();
  std::vector<const char*> starts{data};
  for (int i = 1; i < nthreads; ++i) {
    const char* guess = data + buf.size() * i / nthreads;
    while (guess < end && *guess != ';' && *guess != '\n') ++guess;
    starts.push_back(guess < end ? guess + 1 : end);
  }
  starts.push_back(end);

  std::vector<ChunkOut> outs(static_cast<size_t>(nthreads));
  std::vector<std::thread> threads;
  for (int i = 0; i < nthreads; ++i)
    threads.emplace_back(parse_chunk, starts[i], starts[i + 1],
                         &outs[static_cast<size_t>(i)]);
  for (auto& t : threads) t.join();

  // merge: global vocab in first-appearance order across ordered chunks
  std::map<std::string, int32_t> vocab;
  size_t total = 0;
  for (auto& o : outs) total += o.user.size();
  table->user.reserve(total);
  table->activity.reserve(total);
  table->timestamp.reserve(total);
  table->x.reserve(total);
  table->y.reserve(total);
  table->z.reserve(total);
  for (auto& o : outs) {
    std::vector<int32_t> remap(o.local_names.size());
    for (size_t i = 0; i < o.local_names.size(); ++i) {
      auto it = vocab.find(o.local_names[i]);
      if (it == vocab.end()) {
        int32_t id = static_cast<int32_t>(table->names.size());
        vocab.emplace(o.local_names[i], id);
        table->names.push_back(o.local_names[i]);
        remap[i] = id;
      } else {
        remap[i] = it->second;
      }
    }
    for (int32_t a : o.activity)
      table->activity.push_back(remap[static_cast<size_t>(a)]);
    table->user.insert(table->user.end(), o.user.begin(), o.user.end());
    table->timestamp.insert(table->timestamp.end(), o.timestamp.begin(),
                            o.timestamp.end());
    table->x.insert(table->x.end(), o.x.begin(), o.x.end());
    table->y.insert(table->y.end(), o.y.begin(), o.y.end());
    table->z.insert(table->z.end(), o.z.begin(), o.z.end());
    table->skipped += o.skipped;
  }
  return table.release();
}

const char* raw_error(RawTable* t) {
  return t->error.empty() ? nullptr : t->error.c_str();
}
int64_t raw_nrows(RawTable* t) {
  return static_cast<int64_t>(t->user.size());
}
int64_t raw_skipped(RawTable* t) { return t->skipped; }
int raw_num_activities(RawTable* t) {
  return static_cast<int>(t->names.size());
}
const char* raw_activity_name(RawTable* t, int i) {
  return t->names[static_cast<size_t>(i)].c_str();
}
void raw_users(RawTable* t, int32_t* out) {
  memcpy(out, t->user.data(), t->user.size() * sizeof(int32_t));
}
void raw_activities(RawTable* t, int32_t* out) {
  memcpy(out, t->activity.data(), t->activity.size() * sizeof(int32_t));
}
void raw_timestamps(RawTable* t, int64_t* out) {
  memcpy(out, t->timestamp.data(), t->timestamp.size() * sizeof(int64_t));
}
void raw_xyz(RawTable* t, float* out) {
  // interleaved (n, 3) row-major
  size_t n = t->x.size();
  for (size_t i = 0; i < n; ++i) {
    out[3 * i + 0] = t->x[i];
    out[3 * i + 1] = t->y[i];
    out[3 * i + 2] = t->z[i];
  }
}
void raw_free(RawTable* t) { delete t; }

}  // extern "C"
