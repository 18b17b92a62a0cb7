/* Embedded PyTorch device runtime: the native -> GPU dispatch path of the
 * PyTorch/CUDA port (the sibling of jax_runtime.cpp, which hosts the JAX
 * package).
 *
 * A JVM (through src/jni/), a C program or a Spark executor loads
 * libspark_rapids_tpu_torch.so and dispatches table ops that run on the
 * port's kernels, on the card. The library exports the same C ABI as the
 * JAX shim (the srt_jax_* entry points of spark_rapids_tpu/c_api.h; their
 * "jax" is the ABI's name), so the JNI bridge and src/tools/native_demo.cpp
 * link against either library unchanged, plus one marker symbol of its
 * own, srt_runtime_package(), which names the package it embeds.
 *
 * Two embedding modes, decided at srt_jax_init():
 *   - JOIN: the calling process already runs Python (the ctypes binding in
 *     spark_rapids_jni_tpu_torch/utils/native.py): reuse its interpreter
 *     through the GIL-state API.
 *   - HOST: a pure native caller: initialize an interpreter, its Python
 *     home from $SRT_PYTHON_EXECUTABLE (venv aware), and add the
 *     $SRT_PYTHONPATH entries so a source tree resolves.
 *
 * The device: $SPARK_RAPIDS_TPU_DEVICE, read once at srt_jax_init(),
 * "cuda" (the default) or "cpu"; any other value is SRT_ERR_INVALID. It
 * is passed as device= to every bridge call that uploads
 * (table_op_wire, table_upload_wire, platform); a resident table stays
 * on the device it was uploaded to. A caller sets it the way a caller of
 * the JAX shim sets JAX_PLATFORMS: in the environment, or through
 * srt_set_runtime_flag, before srt_jax_init().
 *
 * All compute goes through spark_rapids_jni_tpu_torch.runtime_bridge (see
 * its docstring for the wire format).
 */

#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "error.hpp"
#include "spark_rapids_tpu/c_api.h"

using spark_rapids_tpu::expects;
using spark_rapids_tpu::srt_error;
using spark_rapids_tpu::translate;

extern "C" SRT_EXPORT const char* srt_runtime_package(void);

namespace {

struct Runtime {
  std::mutex mu;
  bool initialized = false;
  bool owns_interpreter = false;
  PyObject* bridge = nullptr;  // spark_rapids_jni_tpu_torch.runtime_bridge
  std::string device = "cuda";  // $SPARK_RAPIDS_TPU_DEVICE at init
};

constexpr const char* kBridge = "spark_rapids_jni_tpu_torch.runtime_bridge";

Runtime& runtime() {
  static Runtime r;
  return r;
}

/* RAII GIL acquisition for entry points after init. */
class GilGuard {
 public:
  GilGuard() : state_(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

/* Render the pending Python exception into an srt_error. */
[[noreturn]] void throw_python_error(const char* where) {
  std::string msg = std::string(where) + ": python error";
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg = std::string(where) + ": " + c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  throw srt_error(SRT_ERR_UNKNOWN, msg);
}

void start_interpreter() {
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  const char* exe = std::getenv("SRT_PYTHON_EXECUTABLE");
#ifdef SRT_PYTHON_DEFAULT
  if (exe == nullptr || exe[0] == '\0') exe = SRT_PYTHON_DEFAULT;
#endif
  if (exe != nullptr && exe[0] != '\0') {
    PyConfig_SetBytesString(&config, &config.program_name, exe);
  }
  PyStatus status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(status)) {
    throw srt_error(SRT_ERR_UNKNOWN,
                    std::string("python init failed: ") +
                        (status.err_msg ? status.err_msg : "?"));
  }
}

void add_pythonpath_entries() {
  const char* extra = std::getenv("SRT_PYTHONPATH");
  if (extra == nullptr || extra[0] == '\0') return;
  PyObject* sys_path = PySys_GetObject("path");  // borrowed
  if (sys_path == nullptr) throw_python_error("sys.path");
  std::string all(extra);
  size_t start = 0;
  while (start <= all.size()) {
    size_t end = all.find(':', start);
    if (end == std::string::npos) end = all.size();
    std::string entry = all.substr(start, end - start);
    if (!entry.empty()) {
      PyObject* s = PyUnicode_FromString(entry.c_str());
      if (s == nullptr) throw_python_error("path entry");
      PyList_Insert(sys_path, 0, s);
      Py_DECREF(s);
    }
    start = end + 1;
  }
}

/* The device every uploading bridge call gets, read once at init. */
std::string read_device() {
  const char* dev = std::getenv("SPARK_RAPIDS_TPU_DEVICE");
  if (dev == nullptr || dev[0] == '\0') return "cuda";
  std::string d(dev);
  if (d != "cuda" && d != "cpu") {
    throw srt_error(SRT_ERR_INVALID,
                    "SPARK_RAPIDS_TPU_DEVICE must be cuda or cpu, got '" +
                        d + "'");
  }
  return d;
}

void ensure_init() {
  Runtime& rt = runtime();
  std::lock_guard<std::mutex> lock(rt.mu);
  if (rt.initialized) return;
  rt.device = read_device();
  if (Py_IsInitialized() == 0) {
    start_interpreter();
    rt.owns_interpreter = true;
    /* From here the GIL must be released on EVERY exit — a throw that
     * kept it held would deadlock every later call on other threads
     * (and a same-thread retry takes the JOIN branch below, whose
     * GilGuard only balances its own Ensure). */
    try {
      add_pythonpath_entries();
      PyObject* mod =
          PyImport_ImportModule(kBridge);
      if (mod == nullptr) throw_python_error("import runtime_bridge");
      rt.bridge = mod;
      rt.initialized = true;
    } catch (...) {
      PyEval_SaveThread();
      throw;
    }
    PyEval_SaveThread();
  } else {
    GilGuard gil;
    add_pythonpath_entries();
    PyObject* mod =
        PyImport_ImportModule(kBridge);
    if (mod == nullptr) throw_python_error("import runtime_bridge");
    rt.bridge = mod;
    rt.initialized = true;
  }
}

PyObject* bridge_attr(const char* name) {
  PyObject* fn = PyObject_GetAttrString(runtime().bridge, name);
  if (fn == nullptr) throw_python_error(name);
  return fn;
}

/* fn(*args, device=<the runtime's device>); a new reference or nullptr
 * with the Python error set. Steals nothing. */
PyObject* call_on_device(PyObject* fn, PyObject* args) {
  PyObject* kwargs = Py_BuildValue("{s:s}", "device",
                                   runtime().device.c_str());
  if (kwargs == nullptr) return nullptr;
  PyObject* res = PyObject_Call(fn, args, kwargs);
  Py_DECREF(kwargs);
  return res;
}

/* bytes-or-None from a registry handle (0 = None). */
PyObject* buffer_to_py(srt_handle h) {
  if (h == 0) Py_RETURN_NONE;
  void* data = srt_buffer_data(h);
  int64_t size = srt_buffer_size(h);
  expects(data != nullptr && size >= 0, SRT_ERR_HANDLE,
          "unknown buffer handle in table op");
  PyObject* bytes = PyBytes_FromStringAndSize(
      static_cast<const char*>(data), static_cast<Py_ssize_t>(size));
  if (bytes == nullptr) throw_python_error("buffer bytes");
  return bytes;
}

/* Build the four wire argument lists (ids, scales, datas, valids) from
 * registry handles; throws with everything released on failure. */
struct WireArgs {
  PyObject* ids = nullptr;
  PyObject* scales = nullptr;
  PyObject* datas = nullptr;
  PyObject* valids = nullptr;

  ~WireArgs() {
    Py_XDECREF(ids);
    Py_XDECREF(scales);
    Py_XDECREF(datas);
    Py_XDECREF(valids);
  }
};

void build_wire_args(WireArgs& w, const int32_t* type_ids,
                     const int32_t* scales, int32_t num_columns,
                     const srt_handle* col_data,
                     const srt_handle* col_valid) {
  w.ids = PyList_New(num_columns);
  w.scales = PyList_New(num_columns);
  w.datas = PyList_New(num_columns);
  w.valids = PyList_New(num_columns);
  expects(w.ids != nullptr && w.scales != nullptr && w.datas != nullptr &&
              w.valids != nullptr,
          SRT_ERR_UNKNOWN, "argument list allocation failed");
  for (int32_t i = 0; i < num_columns; ++i) {
    PyObject* id_obj = PyLong_FromLong(type_ids[i]);
    PyObject* sc_obj = PyLong_FromLong(scales[i]);
    expects(id_obj != nullptr && sc_obj != nullptr, SRT_ERR_UNKNOWN,
            "int allocation failed");
    PyList_SET_ITEM(w.ids, i, id_obj);
    PyList_SET_ITEM(w.scales, i, sc_obj);
    PyList_SET_ITEM(w.datas, i, buffer_to_py(col_data[i]));
    PyList_SET_ITEM(w.valids, i, buffer_to_py(col_valid[i]));
  }
}

/* Validate + unpack a (type_ids, scales, datas, valids, num_rows) wire
 * result into freshly created registry handles. Borrows `res`; on any
 * failure every handle created so far is released and an srt_error is
 * thrown — the registry can never leak (RowConversion.java cleanup
 * discipline). */
void unpack_wire_result(PyObject* res, int32_t max_out_columns,
                        int32_t* out_type_ids, int32_t* out_scales,
                        int32_t* out_num_columns, srt_handle* out_col_data,
                        srt_handle* out_col_valid, int64_t* out_num_rows) {
  if (!PyTuple_Check(res) || PyTuple_GET_SIZE(res) != 5) {
    throw srt_error(SRT_ERR_UNKNOWN, "wire result: bad shape");
  }
  PyObject* r_ids = PyTuple_GET_ITEM(res, 0);
  PyObject* r_scales = PyTuple_GET_ITEM(res, 1);
  PyObject* r_datas = PyTuple_GET_ITEM(res, 2);
  PyObject* r_valids = PyTuple_GET_ITEM(res, 3);
  PyObject* r_rows = PyTuple_GET_ITEM(res, 4);
  if (!PyList_Check(r_ids) || !PyList_Check(r_scales) ||
      !PyList_Check(r_datas) || !PyList_Check(r_valids) ||
      !PyLong_Check(r_rows)) {
    throw srt_error(SRT_ERR_UNKNOWN, "wire result: bad types");
  }
  Py_ssize_t n_out = PyList_GET_SIZE(r_ids);
  if (PyList_GET_SIZE(r_scales) != n_out ||
      PyList_GET_SIZE(r_datas) != n_out ||
      PyList_GET_SIZE(r_valids) != n_out) {
    throw srt_error(SRT_ERR_UNKNOWN, "wire result: ragged lists");
  }
  if (n_out > max_out_columns) {
    throw srt_error(SRT_ERR_OVERFLOW,
                    "result has more columns than max_out_columns");
  }
  std::vector<srt_handle> created;
  created.reserve(static_cast<size_t>(2 * n_out));
  try {
    for (Py_ssize_t i = 0; i < n_out; ++i) {
      PyObject* d = PyList_GetItem(r_datas, i);
      PyObject* v = PyList_GetItem(r_valids, i);
      PyObject* id_obj = PyList_GetItem(r_ids, i);
      PyObject* sc_obj = PyList_GetItem(r_scales, i);
      expects(id_obj != nullptr && PyLong_Check(id_obj) &&
                  sc_obj != nullptr && PyLong_Check(sc_obj),
              SRT_ERR_UNKNOWN, "wire result: non-int id/scale");
      expects(d != nullptr && PyBytes_Check(d), SRT_ERR_UNKNOWN,
              "wire result: data not bytes");
      srt_handle hd = srt_buffer_create(
          PyBytes_AS_STRING(d), PyBytes_GET_SIZE(d), "torch-op-out");
      expects(hd != 0, SRT_ERR_UNKNOWN, "buffer create failed");
      created.push_back(hd);
      srt_handle hv = 0;
      if (v != nullptr && v != Py_None) {
        expects(PyBytes_Check(v), SRT_ERR_UNKNOWN,
                "wire result: validity not bytes");
        hv = srt_buffer_create(PyBytes_AS_STRING(v), PyBytes_GET_SIZE(v),
                               "torch-op-out-valid");
        expects(hv != 0, SRT_ERR_UNKNOWN, "buffer create failed");
        created.push_back(hv);
      }
      out_type_ids[i] = static_cast<int32_t>(PyLong_AsLong(id_obj));
      out_scales[i] = static_cast<int32_t>(PyLong_AsLong(sc_obj));
      out_col_data[i] = hd;
      out_col_valid[i] = hv;
    }
  } catch (...) {
    for (srt_handle h : created) srt_buffer_release(h);
    throw;
  }
  *out_num_columns = static_cast<int32_t>(n_out);
  *out_num_rows = static_cast<int64_t>(PyLong_AsLongLong(r_rows));
}

/* Call a bridge function returning an int64 (table ids, counts). */
int64_t call_int64(PyObject* res, const char* where) {
  if (res == nullptr) throw_python_error(where);
  if (!PyLong_Check(res)) {
    Py_DECREF(res);
    throw srt_error(SRT_ERR_UNKNOWN,
                    std::string(where) + ": non-int result");
  }
  int64_t out = static_cast<int64_t>(PyLong_AsLongLong(res));
  Py_DECREF(res);
  return out;
}

}  // namespace

extern "C" {

const char* srt_runtime_package(void) { return "spark_rapids_jni_tpu_torch"; }

int32_t srt_jax_available(void) { return 1; }

srt_status srt_jax_init(void) {
  return translate([] { ensure_init(); });
}

srt_status srt_jax_platform(char* buf, int64_t buflen) {
  return translate([&] {
    expects(buf != nullptr && buflen > 0, SRT_ERR_NULLPTR, "null buffer");
    ensure_init();
    GilGuard gil;
    PyObject* fn = bridge_attr("platform");
    PyObject* args = PyTuple_New(0);
    PyObject* res = args == nullptr ? nullptr : call_on_device(fn, args);
    Py_XDECREF(args);
    Py_DECREF(fn);
    if (res == nullptr) throw_python_error("platform()");
    const char* name = PyUnicode_AsUTF8(res);
    if (name == nullptr) {
      Py_DECREF(res);
      throw_python_error("platform() result");
    }
    std::strncpy(buf, name, static_cast<size_t>(buflen - 1));
    buf[buflen - 1] = '\0';
    Py_DECREF(res);
  });
}

srt_status srt_jax_table_op(
    const char* op_json, const int32_t* type_ids, const int32_t* scales,
    int32_t num_columns, const srt_handle* col_data,
    const srt_handle* col_valid, int64_t num_rows, int32_t max_out_columns,
    int32_t* out_type_ids, int32_t* out_scales, int32_t* out_num_columns,
    srt_handle* out_col_data, srt_handle* out_col_valid,
    int64_t* out_num_rows) {
  return translate([&] {
    expects(op_json != nullptr, SRT_ERR_NULLPTR, "null op_json");
    expects(num_columns >= 0, SRT_ERR_INVALID, "negative column count");
    expects(num_columns == 0 ||
                (type_ids != nullptr && scales != nullptr &&
                 col_data != nullptr && col_valid != nullptr),
            SRT_ERR_NULLPTR, "null column arrays");
    expects(out_type_ids != nullptr && out_scales != nullptr &&
                out_num_columns != nullptr && out_col_data != nullptr &&
                out_col_valid != nullptr && out_num_rows != nullptr,
            SRT_ERR_NULLPTR, "null output arrays");
    ensure_init();
    GilGuard gil;

    PyObject* res = nullptr;
    try {
      WireArgs w;
      build_wire_args(w, type_ids, scales, num_columns, col_data,
                      col_valid);
      PyObject* fn = bridge_attr("table_op_wire");
      PyObject* args = Py_BuildValue(
          "(sOOOOL)", op_json, w.ids, w.scales, w.datas, w.valids,
          static_cast<long long>(num_rows));
      res = args == nullptr ? nullptr : call_on_device(fn, args);
      Py_XDECREF(args);
      Py_DECREF(fn);
      if (res == nullptr) throw_python_error("table_op_wire");
    } catch (...) {
      if (PyErr_Occurred()) PyErr_Clear();
      throw;
    }
    try {
      unpack_wire_result(res, max_out_columns, out_type_ids, out_scales,
                         out_num_columns, out_col_data, out_col_valid,
                         out_num_rows);
    } catch (...) {
      Py_DECREF(res);
      throw;
    }
    Py_DECREF(res);
  });
}

srt_status srt_jax_table_upload(
    const int32_t* type_ids, const int32_t* scales, int32_t num_columns,
    const srt_handle* col_data, const srt_handle* col_valid,
    int64_t num_rows, srt_table* out_table) {
  return translate([&] {
    expects(num_columns > 0 && type_ids != nullptr && scales != nullptr &&
                col_data != nullptr && col_valid != nullptr,
            SRT_ERR_NULLPTR, "null column arrays");
    expects(out_table != nullptr, SRT_ERR_NULLPTR, "null out_table");
    ensure_init();
    GilGuard gil;
    PyObject* res = nullptr;
    try {
      WireArgs w;
      build_wire_args(w, type_ids, scales, num_columns, col_data,
                      col_valid);
      PyObject* fn = bridge_attr("table_upload_wire");
      PyObject* args = Py_BuildValue(
          "(OOOOL)", w.ids, w.scales, w.datas, w.valids,
          static_cast<long long>(num_rows));
      res = args == nullptr ? nullptr : call_on_device(fn, args);
      Py_XDECREF(args);
      Py_DECREF(fn);
    } catch (...) {
      if (PyErr_Occurred()) PyErr_Clear();
      throw;
    }
    *out_table = call_int64(res, "table_upload_wire");
  });
}

srt_status srt_jax_table_op_resident(
    const char* op_json, const srt_table* inputs, int32_t num_inputs,
    srt_table* out_table) {
  return translate([&] {
    expects(op_json != nullptr, SRT_ERR_NULLPTR, "null op_json");
    expects(inputs != nullptr && num_inputs > 0, SRT_ERR_NULLPTR,
            "null inputs");
    expects(out_table != nullptr, SRT_ERR_NULLPTR, "null out_table");
    ensure_init();
    GilGuard gil;
    PyObject* res = nullptr;
    PyObject* ids = nullptr;
    try {
      ids = PyList_New(num_inputs);
      expects(ids != nullptr, SRT_ERR_UNKNOWN, "list allocation failed");
      for (int32_t i = 0; i < num_inputs; ++i) {
        PyObject* v = PyLong_FromLongLong(inputs[i]);
        expects(v != nullptr, SRT_ERR_UNKNOWN, "int allocation failed");
        PyList_SET_ITEM(ids, i, v);
      }
      PyObject* fn = bridge_attr("table_op_resident");
      res = PyObject_CallFunction(fn, "sO", op_json, ids);
      Py_DECREF(fn);
      Py_DECREF(ids);
    } catch (...) {
      Py_XDECREF(ids);
      if (PyErr_Occurred()) PyErr_Clear();
      throw;
    }
    *out_table = call_int64(res, "table_op_resident");
  });
}

srt_status srt_jax_table_download(
    srt_table table, int32_t max_out_columns, int32_t* out_type_ids,
    int32_t* out_scales, int32_t* out_num_columns,
    srt_handle* out_col_data, srt_handle* out_col_valid,
    int64_t* out_num_rows) {
  return translate([&] {
    expects(out_type_ids != nullptr && out_scales != nullptr &&
                out_num_columns != nullptr && out_col_data != nullptr &&
                out_col_valid != nullptr && out_num_rows != nullptr,
            SRT_ERR_NULLPTR, "null output arrays");
    ensure_init();
    GilGuard gil;
    PyObject* fn = bridge_attr("table_download_wire");
    PyObject* res =
        PyObject_CallFunction(fn, "L", static_cast<long long>(table));
    Py_DECREF(fn);
    if (res == nullptr) throw_python_error("table_download_wire");
    try {
      unpack_wire_result(res, max_out_columns, out_type_ids, out_scales,
                         out_num_columns, out_col_data, out_col_valid,
                         out_num_rows);
    } catch (...) {
      Py_DECREF(res);
      throw;
    }
    Py_DECREF(res);
  });
}

srt_status srt_jax_table_num_rows(srt_table table, int64_t* out_num_rows) {
  return translate([&] {
    expects(out_num_rows != nullptr, SRT_ERR_NULLPTR, "null out");
    ensure_init();
    GilGuard gil;
    PyObject* fn = bridge_attr("table_num_rows");
    PyObject* res =
        PyObject_CallFunction(fn, "L", static_cast<long long>(table));
    Py_DECREF(fn);
    *out_num_rows = call_int64(res, "table_num_rows");
  });
}

srt_status srt_jax_table_free(srt_table table) {
  return translate([&] {
    ensure_init();
    GilGuard gil;
    PyObject* fn = bridge_attr("table_free");
    PyObject* res =
        PyObject_CallFunction(fn, "L", static_cast<long long>(table));
    Py_DECREF(fn);
    if (res == nullptr) throw_python_error("table_free");
    Py_DECREF(res);
  });
}

srt_status srt_jax_resident_table_count(int64_t* out_count) {
  return translate([&] {
    expects(out_count != nullptr, SRT_ERR_NULLPTR, "null out");
    ensure_init();
    GilGuard gil;
    PyObject* fn = bridge_attr("resident_table_count");
    PyObject* res = PyObject_CallNoArgs(fn);
    Py_DECREF(fn);
    *out_count = call_int64(res, "resident_table_count");
  });
}

}  // extern "C"

