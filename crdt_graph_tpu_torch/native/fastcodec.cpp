// Native wire codec: reference-format JSON -> packed operation columns.
//
// The merge consumes struct-of-array operation batches
// (codec/packed.py).  The pure-Python path (json.loads -> Operation objects
// -> pack()) builds millions of Python objects per large batch and caps
// ingest around half a million ops/s — far below the device's merge rate.
// This extension parses the wire format (CRDTree/Operation.elm:109-159 —
// {"op":"add","path":[..],"ts":n,"val":..}, {"op":"del","path":[..]},
// {"op":"batch","ops":[..]}, unknown tags = empty batch) straight into
// int64/int32/int8 columns in a single pass, building Python objects only
// for the opaque "val" payloads.
//
// Exposed as crdt_graph_tpu_torch.native._fastcodec.parse_pack(payload,
// max_depth)
// -> dict of bytes columns + values list + count; the Python wrapper wraps
// them in numpy without copying (np.frombuffer) and pads to capacity.
// Semantics (flatten order, strict ints, range checks) mirror
// codec/json_codec.py + codec/packed.py and are pinned by
// tests/test_torch_native.py against the JAX package's copy of this file.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int64_t MAX_TS = int64_t(1) << 62;  // kernel sentinel space

struct Columns {
  std::vector<int8_t> kind;
  std::vector<int64_t> ts, parent, anchor;
  std::vector<int32_t> depth, value_ref;
  std::vector<int64_t> paths;  // row-major [n, max_depth]
  PyObject* values;            // list of parsed "val" payloads
  int max_depth;
};

struct Parser {
  const char* begin;
  const char* p;
  const char* end;
  std::string err;
  int value_depth = 0;  // recursion guard for value_py/skip_value

  // Untrusted wire input must not be able to overflow the C stack with
  // deep nesting (Python's json raises RecursionError; we fail the parse).
  // 512 matches the operation() batch-nesting cap.
  static constexpr int kMaxValueDepth = 512;

  struct DepthGuard {
    int& d;
    bool ok;
    explicit DepthGuard(int& depth)
        : d(depth), ok(++depth <= kMaxValueDepth) {}
    ~DepthGuard() { --d; }
  };

  explicit Parser(const char* data, Py_ssize_t n)
      : begin(data), p(data), end(data + n) {}

  bool fail(const std::string& m) {
    if (err.empty()) {
      err = m + " at offset " + std::to_string(size_t(p - begin));
    }
    return false;
  }

  void ws() {
    while (p < end &&
           (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) {
      ++p;
    }
  }

  bool lit(const char* s) {
    size_t n = std::strlen(s);
    if (size_t(end - p) < n || std::memcmp(p, s, n) != 0) {
      return fail(std::string("expected '") + s + "'");
    }
    p += n;
    return true;
  }

  // ---- numbers ----
  // Integral JSON number -> int64 (strict: JSON int grammar -?(0|[1-9]\d*),
  // no fraction/exponent, in-range).
  bool int64_field(int64_t* out) {
    ws();
    bool neg = false;
    if (p < end && *p == '-') { neg = true; ++p; }
    if (p >= end || *p < '0' || *p > '9') return fail("expected integer");
    if (*p == '0' && p + 1 < end && p[1] >= '0' && p[1] <= '9') {
      return fail("leading zero in integer");
    }
    uint64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      uint64_t d = uint64_t(*p - '0');
      if (v > (UINT64_MAX - d) / 10) return fail("integer overflow");
      v = v * 10 + d;
      ++p;
    }
    if (p < end && (*p == '.' || *p == 'e' || *p == 'E')) {
      return fail("expected integer, got float");
    }
    // The wire's integer domain is [0, MAX_TS): the merge kernel's int32
    // bit-half sort keys assume ts < 2^62 (merge.py _split_ts), so a
    // well-formed wire op past the bound would silently corrupt bulk
    // merges while the host path absorbed it — both ingest paths reject
    // at decode (json_codec._int_field matches).  Single source of
    // truth for the domain; emit() no longer re-checks.
    // JSON "-0" parses to 0 on the Python path (json.loads), so it must
    // here too; any other negative is out of the wire domain
    if ((neg && v != 0) || v >= uint64_t(MAX_TS)) {
      return fail("integer out of range");
    }
    *out = int64_t(v);
    return true;
  }

  // Full JSON number grammar: int frac? exp?  (used for value payloads).
  bool scan_number(bool* is_float) {
    *is_float = false;
    if (p < end && *p == '-') ++p;
    if (p >= end || *p < '0' || *p > '9') return fail("bad number");
    if (*p == '0') {
      ++p;
    } else {
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    if (p < end && *p == '.') {
      *is_float = true;
      ++p;
      if (p >= end || *p < '0' || *p > '9') return fail("bad number");
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
      *is_float = true;
      ++p;
      if (p < end && (*p == '+' || *p == '-')) ++p;
      if (p >= end || *p < '0' || *p > '9') return fail("bad number");
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    return true;
  }

  // ---- strings ----
  bool hex4(unsigned* out) {
    if (end - p < 4) return fail("bad \\u escape");
    unsigned v = 0;
    for (int i = 0; i < 4; i++) {
      char c = p[i];
      unsigned d;
      if (c >= '0' && c <= '9') d = c - '0';
      else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
      else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
      else return fail("bad \\u escape");
      v = (v << 4) | d;
    }
    p += 4;
    *out = v;
    return true;
  }

  static void append_utf8(std::string& s, unsigned cp) {
    if (cp < 0x80) {
      s += char(cp);
    } else if (cp < 0x800) {
      s += char(0xC0 | (cp >> 6));
      s += char(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
      s += char(0xE0 | (cp >> 12));
      s += char(0x80 | ((cp >> 6) & 0x3F));
      s += char(0x80 | (cp & 0x3F));
    } else {
      s += char(0xF0 | (cp >> 18));
      s += char(0x80 | ((cp >> 12) & 0x3F));
      s += char(0x80 | ((cp >> 6) & 0x3F));
      s += char(0x80 | (cp & 0x3F));
    }
  }

  bool string_raw(std::string* out) {
    ws();
    if (p >= end || *p != '"') return fail("expected string");
    ++p;
    out->clear();
    while (p < end) {
      unsigned char c = *p;
      if (c == '"') { ++p; return true; }
      if (c == '\\') {
        ++p;
        if (p >= end) return fail("unterminated escape");
        char e = *p++;
        switch (e) {
          case '"': *out += '"'; break;
          case '\\': *out += '\\'; break;
          case '/': *out += '/'; break;
          case 'b': *out += '\b'; break;
          case 'f': *out += '\f'; break;
          case 'n': *out += '\n'; break;
          case 'r': *out += '\r'; break;
          case 't': *out += '\t'; break;
          case 'u': {
            unsigned cp;
            if (!hex4(&cp)) return false;
            if (cp >= 0xD800 && cp <= 0xDBFF) {  // high surrogate
              if (end - p >= 2 && p[0] == '\\' && p[1] == 'u') {
                const char* save = p;
                p += 2;
                unsigned lo;
                if (!hex4(&lo)) return false;
                if (lo >= 0xDC00 && lo <= 0xDFFF) {
                  cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                } else {
                  p = save;  // lone high surrogate kept, like json.loads
                }
              }
              // lone surrogates encode as WTF-8; decoded with
              // "surrogatepass" below, matching Python's json.loads
            }
            append_utf8(*out, cp);
            break;
          }
          default:
            return fail("bad escape");
        }
      } else if (c < 0x20) {
        return fail("control char in string");
      } else if (c < 0x80) {
        *out += char(c);
        ++p;
      } else {
        // Literal multi-byte sequence: validate STRICT UTF-8, exactly
        // like json.loads on bytes input (which utf-8-decodes the whole
        // document before parsing — invalid sequences, overlongs,
        // surrogate encodings and > U+10FFFF are all rejections there).
        // Escape-produced lone surrogates take the \u path above and
        // stay admitted (WTF-8), matching Python.
        unsigned cp;
        int extra;
        if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; extra = 1; }
        else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; extra = 2; }
        else if ((c & 0xF8) == 0xF0) { cp = c & 0x07; extra = 3; }
        else return fail("invalid utf-8");
        if (end - p <= extra) return fail("invalid utf-8");
        for (int i = 1; i <= extra; ++i) {
          if ((static_cast<unsigned char>(p[i]) & 0xC0) != 0x80) {
            return fail("invalid utf-8");
          }
          cp = (cp << 6) | (static_cast<unsigned char>(p[i]) & 0x3F);
        }
        static const unsigned kMin[4] = {0, 0x80, 0x800, 0x10000};
        if (cp < kMin[extra] || cp > 0x10FFFF ||
            (cp >= 0xD800 && cp <= 0xDFFF)) {
          return fail("invalid utf-8");
        }
        out->append(reinterpret_cast<const char*>(p), size_t(extra) + 1);
        p += extra + 1;
      }
    }
    return fail("unterminated string");
  }

  // ---- generic values (for "val" payloads) -> Python objects ----
  PyObject* value_py() {
    DepthGuard guard(value_depth);
    if (!guard.ok) { fail("value nesting too deep"); return nullptr; }
    ws();
    if (p >= end) { fail("unexpected end"); return nullptr; }
    switch (*p) {
      case '{': {
        ++p;
        PyObject* d = PyDict_New();
        if (!d) return nullptr;
        ws();
        if (p < end && *p == '}') { ++p; return d; }
        while (true) {
          std::string key;
          if (!string_raw(&key)) { Py_DECREF(d); return nullptr; }
          ws();
          if (p >= end || *p != ':') {
            fail("expected ':'");
            Py_DECREF(d);
            return nullptr;
          }
          ++p;
          PyObject* v = value_py();
          if (!v) { Py_DECREF(d); return nullptr; }
          PyObject* k = PyUnicode_DecodeUTF8(
              key.data(), Py_ssize_t(key.size()), "surrogatepass");
          if (!k || PyDict_SetItem(d, k, v) < 0) {
            Py_XDECREF(k); Py_DECREF(v); Py_DECREF(d);
            return nullptr;
          }
          Py_DECREF(k);
          Py_DECREF(v);
          ws();
          if (p < end && *p == ',') { ++p; continue; }
          if (p < end && *p == '}') { ++p; return d; }
          fail("expected ',' or '}'");
          Py_DECREF(d);
          return nullptr;
        }
      }
      case '[': {
        ++p;
        PyObject* l = PyList_New(0);
        if (!l) return nullptr;
        ws();
        if (p < end && *p == ']') { ++p; return l; }
        while (true) {
          PyObject* v = value_py();
          if (!v) { Py_DECREF(l); return nullptr; }
          if (PyList_Append(l, v) < 0) {
            Py_DECREF(v); Py_DECREF(l);
            return nullptr;
          }
          Py_DECREF(v);
          ws();
          if (p < end && *p == ',') { ++p; continue; }
          if (p < end && *p == ']') { ++p; return l; }
          fail("expected ',' or ']'");
          Py_DECREF(l);
          return nullptr;
        }
      }
      case '"': {
        std::string s;
        if (!string_raw(&s)) return nullptr;
        return PyUnicode_DecodeUTF8(s.data(), Py_ssize_t(s.size()),
                                    "surrogatepass");
      }
      case 't':
        if (!lit("true")) return nullptr;
        Py_RETURN_TRUE;
      case 'f':
        if (!lit("false")) return nullptr;
        Py_RETURN_FALSE;
      case 'n':
        if (!lit("null")) return nullptr;
        Py_RETURN_NONE;
      case 'N':
        if (!lit("NaN")) return nullptr;
        return PyFloat_FromDouble(std::numeric_limits<double>::quiet_NaN());
      case 'I':
        if (!lit("Infinity")) return nullptr;
        return PyFloat_FromDouble(std::numeric_limits<double>::infinity());
      default: {
        // number: validate the JSON grammar, decide int vs float like
        // Python's json (which also accepts -Infinity)
        if (*p == '-' && p + 1 < end && p[1] == 'I') {
          if (!lit("-Infinity")) return nullptr;
          return PyFloat_FromDouble(
              -std::numeric_limits<double>::infinity());
        }
        const char* start = p;
        bool is_float;
        if (!scan_number(&is_float)) return nullptr;
        std::string tok(start, size_t(p - start));
        if (is_float) {
          return PyFloat_FromDouble(strtod(tok.c_str(), nullptr));
        }
        return PyLong_FromString(tok.c_str(), nullptr, 10);
      }
    }
  }

  // Validate-and-skip a JSON value textually (no Python objects built).
  bool skip_value() {
    DepthGuard guard(value_depth);
    if (!guard.ok) return fail("value nesting too deep");
    ws();
    if (p >= end) return fail("unexpected end");
    switch (*p) {
      case '{': {
        ++p;
        ws();
        if (p < end && *p == '}') { ++p; return true; }
        while (true) {
          std::string key;
          if (!string_raw(&key)) return false;
          ws();
          if (p >= end || *p != ':') return fail("expected ':'");
          ++p;
          if (!skip_value()) return false;
          ws();
          if (p < end && *p == ',') { ++p; ws(); continue; }
          if (p < end && *p == '}') { ++p; return true; }
          return fail("expected ',' or '}'");
        }
      }
      case '[': {
        ++p;
        ws();
        if (p < end && *p == ']') { ++p; return true; }
        while (true) {
          if (!skip_value()) return false;
          ws();
          if (p < end && *p == ',') { ++p; continue; }
          if (p < end && *p == ']') { ++p; return true; }
          return fail("expected ',' or ']'");
        }
      }
      case '"': {
        std::string s;
        return string_raw(&s);
      }
      case 't':
        return lit("true");
      case 'f':
        return lit("false");
      case 'n':
        return lit("null");
      case 'N':
        return lit("NaN");
      case 'I':
        return lit("Infinity");
      default: {
        if (*p == '-' && p + 1 < end && p[1] == 'I') {
          return lit("-Infinity");
        }
        bool is_float;
        return scan_number(&is_float);
      }
    }
  }

  // ---- operations ----
  bool path_field(std::vector<int64_t>* out) {
    ws();
    if (p >= end || *p != '[') return fail("expected path list");
    ++p;
    out->clear();
    ws();
    if (p < end && *p == ']') { ++p; return true; }
    while (true) {
      int64_t v;
      if (!int64_field(&v)) return false;
      out->push_back(v);
      ws();
      if (p < end && *p == ',') { ++p; continue; }
      if (p < end && *p == ']') { ++p; return true; }
      return fail("expected ',' or ']' in path");
    }
  }

  bool emit(Columns* c, int8_t kind, int64_t ts,
            const std::vector<int64_t>& path, PyObject* val) {
    int D = c->max_depth;
    if (int(path.size()) > D) {
      return fail("path depth " + std::to_string(path.size()) +
                  " exceeds max_depth " + std::to_string(D));
    }
    // ts and path elements were domain-checked at parse (int64_field:
    // [0, MAX_TS)), so no per-element re-check here
    c->kind.push_back(kind);
    c->depth.push_back(int32_t(path.size()));
    int64_t last = path.empty() ? 0 : path.back();
    int64_t par = path.size() >= 2 ? path[path.size() - 2] : 0;
    c->parent.push_back(par);
    if (kind == 0) {  // add
      c->ts.push_back(ts);
      c->anchor.push_back(last);
      c->value_ref.push_back(int32_t(PyList_GET_SIZE(c->values)));
      if (PyList_Append(c->values, val) < 0) return false;
    } else {  // delete
      c->ts.push_back(last);
      c->anchor.push_back(last);
      c->value_ref.push_back(-1);
    }
    size_t row = c->paths.size();
    c->paths.resize(row + size_t(D), 0);
    std::memcpy(c->paths.data() + row, path.data(),
                path.size() * sizeof(int64_t));
    return true;
  }

  // One operation object; flattens batches depth-first.  Duplicate keys
  // follow JSON object semantics (last occurrence wins, matching Python's
  // json.loads): fields are collected with overwrite, the raw "ops" span
  // is remembered rather than parsed inline, and leaves are emitted only
  // after the object closes — so the final tag governs and only the final
  // "ops" list contributes.
  bool operation(Columns* c, int depth_guard) {
    if (depth_guard > 512) return fail("batch nesting too deep");
    ws();
    if (p >= end || *p != '{') return fail("expected operation object");
    ++p;
    // Every field is grammar-validated as generic JSON during the object
    // walk (matching json.loads, which parses the whole document before
    // any semantic check); "ts"/"path"/"ops" are remembered as raw spans
    // and re-parsed with the tag's SEMANTIC rules only after the object
    // closes and the final tag is known.  Unknown tags therefore tolerate
    // arbitrary field contents, exactly like the Python decoder.
    bool has_op = false, has_val = false;
    bool tag_is_string = false;
    std::string tag;
    PyObject* val = nullptr;
    const char* ts_span = nullptr, *ts_span_end = nullptr;
    const char* path_span = nullptr, *path_span_end = nullptr;
    const char* ops_span = nullptr, *ops_span_end = nullptr;
    bool ok = true;
    bool done = false;
    ws();
    if (p < end && *p == '}') { ++p; ok = fail("missing 'op' tag"); done = true; }
    while (ok && !done) {
      std::string key;
      if (!(ok = string_raw(&key))) break;
      ws();
      if (p >= end || *p != ':') { ok = fail("expected ':'"); break; }
      ++p;
      if (key == "op") {
        // a non-string tag is not an error: Python's decoder compares
        // obj["op"] against the known tags and falls through to the
        // forward-compatible empty batch, so any JSON value is admitted
        // (last occurrence wins, like every duplicate key)
        ws();
        if (p < end && *p == '"') {
          if (!(ok = string_raw(&tag))) break;
          tag_is_string = true;
        } else {
          if (!(ok = skip_value())) break;
          tag_is_string = false;
        }
        has_op = true;
      } else if (key == "ts") {
        ws();
        ts_span = p;
        if (!(ok = skip_value())) break;
        ts_span_end = p;
      } else if (key == "path") {
        ws();
        path_span = p;
        if (!(ok = skip_value())) break;
        path_span_end = p;
      } else if (key == "val") {
        Py_XDECREF(val);
        val = value_py();
        if (!val) { ok = false; break; }
        has_val = true;
      } else if (key == "ops") {
        ws();
        ops_span = p;
        if (!(ok = skip_value())) break;
        ops_span_end = p;
      } else {
        if (!(ok = skip_value())) break;
      }
      ws();
      if (p < end && *p == ',') { ++p; ws(); continue; }
      if (p < end && *p == '}') { ++p; done = true; break; }
      ok = fail("expected ',' or '}'");
      break;
    }
    if (ok) {
      if (!has_op) {
        ok = fail("missing 'op' tag");
      } else if (!tag_is_string) {
        // unknown (non-string) tag: forward-compatible no-op
      } else if (tag == "add") {
        int64_t ts = 0;
        std::vector<int64_t> path;
        if (ts_span == nullptr || path_span == nullptr || !has_val) {
          ok = fail("malformed add (need ts, path, val)");
        } else {
          ok = reparse(ts_span, ts_span_end,
                       [&] { return int64_field(&ts); }) &&
               reparse(path_span, path_span_end,
                       [&] { return path_field(&path); }) &&
               emit(c, 0, ts, path, val);
        }
      } else if (tag == "del") {
        std::vector<int64_t> path;
        if (path_span == nullptr) {
          ok = fail("malformed del (need path)");
        } else {
          ok = reparse(path_span, path_span_end,
                       [&] { return path_field(&path); }) &&
               emit(c, 1, 0, path, nullptr);
        }
      } else if (tag == "batch") {
        if (ops_span == nullptr) {
          // {"op":"batch"} without ops is malformed in the reference
          ok = fail("malformed batch (need ops)");
        } else {
          ok = reparse(ops_span, ops_span_end,
                       [&] { return ops_list(c, depth_guard); });
        }
      }
      // unknown tag: forward-compatible no-op, nothing emitted
    }
    Py_XDECREF(val);
    return ok;
  }

  // Run ``body`` against a remembered [s, e) span, restoring the cursor.
  template <typename F>
  bool reparse(const char* s, const char* e, F body) {
    const char* save_p = p;
    const char* save_end = end;
    p = s;
    end = e;
    bool ok = body();
    if (ok) {
      ws();
      if (p != end) ok = fail("trailing data in field");
    }
    p = save_p;
    end = save_end;
    return ok;
  }

  bool ops_list(Columns* c, int depth_guard) {
    ws();
    if (p >= end || *p != '[') return fail("expected ops list");
    ++p;
    ws();
    if (p < end && *p == ']') { ++p; return true; }
    while (true) {
      if (!operation(c, depth_guard + 1)) return false;
      ws();
      if (p < end && *p == ',') { ++p; continue; }
      if (p < end && *p == ']') { ++p; return true; }
      return fail("expected ',' or ']' in ops");
    }
  }
};

PyObject* bytes_from(const void* data, size_t nbytes) {
  return PyBytes_FromStringAndSize(static_cast<const char*>(data),
                                   Py_ssize_t(nbytes));
}

PyObject* parse_pack(PyObject*, PyObject* args) {
  Py_buffer buf;
  int max_depth;
  if (!PyArg_ParseTuple(args, "y*i", &buf, &max_depth)) return nullptr;
  if (max_depth <= 0) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "max_depth must be positive");
    return nullptr;
  }
  Columns cols;
  cols.max_depth = max_depth;
  cols.values = PyList_New(0);
  if (!cols.values) { PyBuffer_Release(&buf); return nullptr; }

  Parser parser(static_cast<const char*>(buf.buf), buf.len);
  bool ok = parser.operation(&cols, 0);
  if (ok) {
    parser.ws();
    if (parser.p != parser.end) ok = parser.fail("trailing data");
  }
  PyBuffer_Release(&buf);
  if (!ok) {
    Py_DECREF(cols.values);
    if (!PyErr_Occurred()) {
      PyErr_SetString(PyExc_ValueError, parser.err.c_str());
    }
    return nullptr;
  }

  size_t n = cols.kind.size();
  // Link hints (codec/packed.py module docstring): resolve each op's
  // timestamp references to batch positions with one hash map, so the
  // device kernel can use verified gathers instead of a sort-join.
  // First add with a given ts wins, matching the kernel's dedup.
  std::vector<int32_t> parent_pos(n, -1), anchor_pos(n, -1),
      target_pos(n, -1);
  {
    std::unordered_map<int64_t, int32_t> first;
    first.reserve(n * 2);
    for (size_t i = 0; i < n; ++i) {
      if (cols.kind[i] == 0) first.emplace(cols.ts[i], int32_t(i));
    }
    auto look = [&](int64_t t) -> int32_t {
      if (!t) return -1;
      auto it = first.find(t);
      return it == first.end() ? -1 : it->second;
    };
    for (size_t i = 0; i < n; ++i) {
      if (cols.parent[i]) parent_pos[i] = look(cols.parent[i]);
      if (cols.kind[i] == 0) {
        anchor_pos[i] = look(cols.anchor[i]);
      } else {
        target_pos[i] = look(cols.ts[i]);
      }
    }
  }
  PyObject* out = Py_BuildValue(
      "{s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:n}",
      "kind", bytes_from(cols.kind.data(), n),
      "ts", bytes_from(cols.ts.data(), n * 8),
      "parent_ts", bytes_from(cols.parent.data(), n * 8),
      "anchor_ts", bytes_from(cols.anchor.data(), n * 8),
      "depth", bytes_from(cols.depth.data(), n * 4),
      "value_ref", bytes_from(cols.value_ref.data(), n * 4),
      "paths", bytes_from(cols.paths.data(), n * size_t(max_depth) * 8),
      "parent_pos", bytes_from(parent_pos.data(), n * 4),
      "anchor_pos", bytes_from(anchor_pos.data(), n * 4),
      "target_pos", bytes_from(target_pos.data(), n * 4),
      "n", Py_ssize_t(n));
  if (!out) { Py_DECREF(cols.values); return nullptr; }
  if (PyDict_SetItemString(out, "values", cols.values) < 0) {
    Py_DECREF(cols.values);
    Py_DECREF(out);
    return nullptr;
  }
  Py_DECREF(cols.values);
  return out;
}

// ===== Egress: packed columns -> wire JSON ================================
// Mirror of the ingest direction: the reference's full-state bootstrap
// contract is ``operationsSince 0`` serving the whole
// log (CRDTree.elm:408-418), and per-op recursive Python encode is seconds
// at headline scale.  One pass over the columns emits wire bytes that are
// byte-compatible with ``json.dumps(..., separators=(",", ":"))`` of the
// Python codec's output (ensure_ascii escapes, repr floats, insertion-order
// dicts), pinned by the differential suite in tests/test_torch_native.py.

struct Writer {
  std::string out;
  bool ok = true;
  std::string err;

  bool fail(const char* m) {
    if (ok) { err = m; ok = false; }
    return false;
  }

  void raw(const char* s) { out += s; }
  void ch(char c) { out += c; }

  void num_i64(int64_t v) {
    char buf[24];
    auto r = std::to_chars(buf, buf + sizeof buf, v);
    out.append(buf, size_t(r.ptr - buf));
  }

  void esc_unit(unsigned v) {  // \uXXXX, lowercase hex like json.dumps
    static const char* hexdig = "0123456789abcdef";
    out += "\\u";
    out += hexdig[(v >> 12) & 0xF];
    out += hexdig[(v >> 8) & 0xF];
    out += hexdig[(v >> 4) & 0xF];
    out += hexdig[v & 0xF];
  }

  // Python str -> quoted JSON, ensure_ascii=True escapes.  Encoded via
  // surrogatepass so lone surrogates admitted by the parser round-trip
  // (they re-emit as their \uD8xx escapes, exactly like json.dumps).
  bool str_py(PyObject* s) {
    if (PyUnicode_IS_ASCII(s)) {
      // common case: no bytes-object round trip, one escape-scan pass
      const char* q = reinterpret_cast<const char*>(PyUnicode_1BYTE_DATA(s));
      Py_ssize_t len = PyUnicode_GET_LENGTH(s);
      ch('"');
      Py_ssize_t run = 0;
      for (Py_ssize_t i = 0; i < len; ++i) {
        unsigned char c = (unsigned char)q[i];
        // ensure_ascii escapes DEL (0x7f) too, not just controls
        if (c >= 0x20 && c < 0x7f && c != '"' && c != '\\') {
          ++run;
          continue;
        }
        if (run) out.append(q + i - run, size_t(run));
        run = 0;
        switch (c) {
          case '"': raw("\\\""); break;
          case '\\': raw("\\\\"); break;
          case '\b': raw("\\b"); break;
          case '\f': raw("\\f"); break;
          case '\n': raw("\\n"); break;
          case '\r': raw("\\r"); break;
          case '\t': raw("\\t"); break;
          default: esc_unit(c);
        }
      }
      if (run) out.append(q + len - run, size_t(run));
      ch('"');
      return true;
    }
    PyObject* b = PyUnicode_AsEncodedString(s, "utf-8", "surrogatepass");
    if (!b) { PyErr_Clear(); return fail("unencodable string"); }
    const unsigned char* q =
        reinterpret_cast<const unsigned char*>(PyBytes_AS_STRING(b));
    const unsigned char* qe = q + PyBytes_GET_SIZE(b);
    ch('"');
    while (q < qe) {
      unsigned char c = *q;
      if (c < 0x80) {
        switch (c) {
          case '"': raw("\\\""); break;
          case '\\': raw("\\\\"); break;
          case '\b': raw("\\b"); break;
          case '\f': raw("\\f"); break;
          case '\n': raw("\\n"); break;
          case '\r': raw("\\r"); break;
          case '\t': raw("\\t"); break;
          default:
            if (c < 0x20 || c == 0x7f) esc_unit(c);
            else ch(char(c));
        }
        ++q;
      } else {
        unsigned cp;
        int extra;
        if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; extra = 1; }
        else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; extra = 2; }
        else if ((c & 0xF8) == 0xF0) { cp = c & 0x07; extra = 3; }
        else { Py_DECREF(b); return fail("bad utf-8 from str"); }
        if (qe - q <= extra) { Py_DECREF(b); return fail("bad utf-8"); }
        ++q;
        for (int i = 0; i < extra; ++i, ++q) cp = (cp << 6) | (*q & 0x3F);
        if (cp < 0x10000) {
          esc_unit(cp);  // BMP incl. WTF-8 lone surrogates
        } else {
          cp -= 0x10000;
          esc_unit(0xD800 + (cp >> 10));
          esc_unit(0xDC00 + (cp & 0x3FF));
        }
      }
    }
    ch('"');
    Py_DECREF(b);
    return true;
  }

  bool value_py(PyObject* v, int depth) {
    if (depth > Parser::kMaxValueDepth) return fail("value nesting too deep");
    if (v == Py_None) { raw("null"); return true; }
    if (PyBool_Check(v)) {  // before PyLong: bool subclasses int
      raw(v == Py_True ? "true" : "false");
      return true;
    }
    if (PyLong_Check(v)) {
      int overflow = 0;
      long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
      if (overflow == 0 && !(x == -1 && PyErr_Occurred())) {
        num_i64(x);
        return true;
      }
      PyErr_Clear();
      PyObject* s = PyObject_Str(v);  // arbitrary-precision fallback
      if (!s) { PyErr_Clear(); return fail("int str failed"); }
      const char* u = PyUnicode_AsUTF8(s);
      if (!u) { Py_DECREF(s); PyErr_Clear(); return fail("int str failed"); }
      out += u;
      Py_DECREF(s);
      return true;
    }
    if (PyFloat_Check(v)) {
      double d = PyFloat_AS_DOUBLE(v);
      // json.dumps default allow_nan=True spellings
      if (std::isnan(d)) { raw("NaN"); return true; }
      if (std::isinf(d)) { raw(d > 0 ? "Infinity" : "-Infinity"); return true; }
      // float.__repr__'s exact spelling (shortest repr + trailing .0)
      char* s = PyOS_double_to_string(d, 'r', 0, Py_DTSF_ADD_DOT_0,
                                      nullptr);
      if (!s) { PyErr_Clear(); return fail("float repr failed"); }
      out += s;
      PyMem_Free(s);
      return true;
    }
    if (PyUnicode_Check(v)) return str_py(v);
    if (PyList_Check(v) || PyTuple_Check(v)) {
      ch('[');
      Py_ssize_t len = PySequence_Fast_GET_SIZE(v);
      PyObject** items = PySequence_Fast_ITEMS(v);
      for (Py_ssize_t i = 0; i < len; ++i) {
        if (i) ch(',');
        if (!value_py(items[i], depth + 1)) return false;
      }
      ch(']');
      return true;
    }
    if (PyDict_Check(v)) {
      ch('{');
      PyObject* k;
      PyObject* val;
      Py_ssize_t pos = 0;
      bool first = true;
      while (PyDict_Next(v, &pos, &k, &val)) {
        if (!first) ch(',');
        first = false;
        if (PyUnicode_Check(k)) {
          if (!str_py(k)) return false;
        } else if (PyBool_Check(k)) {  // json.dumps key coercions
          raw(k == Py_True ? "\"true\"" : "\"false\"");
        } else if (k == Py_None) {
          raw("\"null\"");
        } else if (PyLong_Check(k) || PyFloat_Check(k)) {
          ch('"');
          if (!value_py(k, depth + 1)) return false;
          ch('"');
        } else {
          return fail("unsupported dict key type");
        }
        ch(':');
        if (!value_py(val, depth + 1)) return false;
      }
      ch('}');
      return true;
    }
    return fail("unsupported value type");
  }
};

PyObject* encode_pack(PyObject*, PyObject* args) {
  Py_buffer kind, ts, depth, paths, value_ref;
  PyObject* values;
  Py_ssize_t start, n, width;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*O!nnn", &kind, &ts, &depth,
                        &paths, &value_ref, &PyList_Type, &values,
                        &start, &n, &width)) {
    return nullptr;
  }
  auto release = [&]() {
    PyBuffer_Release(&kind); PyBuffer_Release(&ts);
    PyBuffer_Release(&depth); PyBuffer_Release(&paths);
    PyBuffer_Release(&value_ref);
  };
  if (n < 0 || start < 0 || start > n || width <= 0 ||
      kind.len < n || ts.len < n * 8 || depth.len < n * 4 ||
      value_ref.len < n * 4 || paths.len < n * width * 8) {
    release();
    PyErr_SetString(PyExc_ValueError, "encode_pack: column size mismatch");
    return nullptr;
  }
  const int8_t* K = static_cast<const int8_t*>(kind.buf);
  const int64_t* T = static_cast<const int64_t*>(ts.buf);
  const int32_t* DP = static_cast<const int32_t*>(depth.buf);
  const int64_t* P = static_cast<const int64_t*>(paths.buf);
  const int32_t* VR = static_cast<const int32_t*>(value_ref.buf);
  Py_ssize_t n_values = PyList_GET_SIZE(values);

  Writer w;
  w.out.reserve(size_t(n - start) * 48 + 32);
  w.raw("{\"op\":\"batch\",\"ops\":[");
  bool first = true;
  for (Py_ssize_t i = start; i < n && w.ok; ++i) {
    if (K[i] == 2) continue;  // padding row
    if (!first) w.ch(',');
    first = false;
    w.raw(K[i] == 0 ? "{\"op\":\"add\",\"path\":["
                    : "{\"op\":\"del\",\"path\":[");
    int32_t d = DP[i];
    if (d > width) d = int32_t(width);
    const int64_t* row = P + size_t(i) * size_t(width);
    for (int32_t j = 0; j < d; ++j) {
      if (j) w.ch(',');
      w.num_i64(row[j]);
    }
    if (K[i] == 0) {
      w.raw("],\"ts\":");
      w.num_i64(T[i]);
      w.raw(",\"val\":");
      int32_t r = VR[i];
      PyObject* v = (r >= 0 && r < n_values)
                        ? PyList_GET_ITEM(values, r) : Py_None;
      if (!w.value_py(v, 0)) break;
      w.ch('}');
    } else {
      w.raw("]}");
    }
  }
  w.raw("]}");
  release();
  if (!w.ok) {
    PyErr_SetString(PyExc_ValueError, w.err.c_str());
    return nullptr;
  }
  return PyBytes_FromStringAndSize(w.out.data(), Py_ssize_t(w.out.size()));
}

PyMethodDef methods[] = {
    {"parse_pack", parse_pack, METH_VARARGS,
     "parse_pack(payload: bytes, max_depth: int) -> dict of packed columns"},
    {"encode_pack", encode_pack, METH_VARARGS,
     "encode_pack(kind, ts, depth, paths, value_ref, values, start, n, "
     "width) -> wire JSON bytes for ops [start, n)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastcodec",
    "Native JSON wire codec for crdt_graph_tpu_torch", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__fastcodec(void) {
  return PyModule_Create(&moduledef);
}
