// vio_native: C++ measurement runtime for the VIO framework.
//
// Re-derivation of the reference's System runtime (reference:
// vins-mono/src/System.cpp:50-72 PubImuData, :289-336 getMeasurements,
// include/System.h:105-115 queues + mutex/condvar) as a CPython extension:
// thread-safe IMU/frame queues, stream-order guards, and IMU↔image time
// pairing with boundary interpolation — all off the Python hot path and
// GIL-released while waiting, so a producer thread can stream sensor data
// while the estimator thread consumes paired packets.
//
// Exposed type:  vio_native.MeasurementPairer
//   push_imu(t, ax, ay, az, gx, gy, gz) -> bool (False = disorder, dropped)
//   push_frame(t, handle)               -> bool
//   next(wait=False)  -> None | (frame_t, handle, list[(t,ax..gz)])
//       IMU rows cover (prev_frame_t, frame_t], the last row interpolated
//       to land exactly on frame_t (System.cpp:372-396 semantics).
//   stats() -> dict
//   close()           -> unblocks any waiting next()

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <array>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <vector>

namespace {

struct ImuSample {
  double t;
  std::array<double, 3> acc;
  std::array<double, 3> gyr;
};

struct FrameMsg {
  double t;
  int64_t handle;
};

class Pairer {
 public:
  bool PushImu(const ImuSample& s) {
    std::lock_guard<std::mutex> lk(m_);
    if (!imu_.empty() && s.t <= imu_.back().t) {
      ++imu_disorder_;  // System.cpp:58-62 disorder rejection
      return false;
    }
    imu_.push_back(s);
    ++imu_count_;
    cv_.notify_one();
    return true;
  }

  bool PushFrame(const FrameMsg& f) {
    std::lock_guard<std::mutex> lk(m_);
    // camera-stream discontinuity guard (System.cpp:93-100)
    if (!frames_.empty() && (f.t < frames_.back().t)) {
      ++frame_disorder_;
      return false;
    }
    frames_.push_back(f);
    ++frame_count_;
    cv_.notify_one();
    return true;
  }

  // Try to pop one (frame, imu-batch) pair. Returns false if not ready.
  bool Next(bool wait, FrameMsg* frame, std::vector<ImuSample>* batch) {
    std::unique_lock<std::mutex> lk(m_);
    for (;;) {
      if (Ready()) break;
      if (!wait || closed_) return false;
      cv_.wait(lk);
    }
    const FrameMsg f = frames_.front();
    frames_.pop_front();
    batch->clear();
    // consume samples in (last_t_, f.t]; keep the straddling sample in the
    // queue (it anchors the next interval), emit an interpolated row at f.t.
    ImuSample prev = last_sample_;
    while (!imu_.empty() && imu_.front().t <= f.t) {
      prev = imu_.front();
      batch->push_back(prev);
      imu_.pop_front();
    }
    if (!imu_.empty() && prev.t < f.t) {
      const ImuSample& nxt = imu_.front();
      const double w = (f.t - prev.t) / (nxt.t - prev.t);
      ImuSample b;
      b.t = f.t;
      for (int i = 0; i < 3; ++i) {
        b.acc[i] = (1.0 - w) * prev.acc[i] + w * nxt.acc[i];
        b.gyr[i] = (1.0 - w) * prev.gyr[i] + w * nxt.gyr[i];
      }
      batch->push_back(b);
      last_sample_ = b;
    } else if (!batch->empty()) {
      last_sample_ = batch->back();
    }
    last_t_ = f.t;
    *frame = f;
    return true;
  }

  void Close() {
    std::lock_guard<std::mutex> lk(m_);
    closed_ = true;
    cv_.notify_all();
  }

  void Stats(int64_t* imu, int64_t* frames, int64_t* imu_dis,
             int64_t* frame_dis, size_t* imu_q, size_t* frame_q) {
    std::lock_guard<std::mutex> lk(m_);
    *imu = imu_count_;
    *frames = frame_count_;
    *imu_dis = imu_disorder_;
    *frame_dis = frame_disorder_;
    *imu_q = imu_.size();
    *frame_q = frames_.size();
  }

 private:
  // a frame is ready once an IMU sample at/after its timestamp exists
  // (System.cpp:300-304: wait until imu_buf.back()->t > img_t)
  bool Ready() const {
    return !frames_.empty() && !imu_.empty() &&
           imu_.back().t >= frames_.front().t;
  }

  std::mutex m_;
  std::condition_variable cv_;
  std::deque<ImuSample> imu_;
  std::deque<FrameMsg> frames_;
  ImuSample last_sample_{};
  double last_t_ = -1.0;
  bool closed_ = false;
  int64_t imu_count_ = 0, frame_count_ = 0;
  int64_t imu_disorder_ = 0, frame_disorder_ = 0;
};

// ---------------------------------------------------------------------------
// CPython boilerplate
// ---------------------------------------------------------------------------

struct PairerObject {
  PyObject_HEAD
  Pairer* pairer;
};

PyObject* Pairer_new(PyTypeObject* type, PyObject*, PyObject*) {
  PairerObject* self = reinterpret_cast<PairerObject*>(type->tp_alloc(type, 0));
  if (self) self->pairer = new Pairer();
  return reinterpret_cast<PyObject*>(self);
}

void Pairer_dealloc(PairerObject* self) {
  delete self->pairer;
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

PyObject* Pairer_push_imu(PairerObject* self, PyObject* args) {
  ImuSample s;
  if (!PyArg_ParseTuple(args, "ddddddd", &s.t, &s.acc[0], &s.acc[1],
                        &s.acc[2], &s.gyr[0], &s.gyr[1], &s.gyr[2]))
    return nullptr;
  bool ok;
  Py_BEGIN_ALLOW_THREADS
  ok = self->pairer->PushImu(s);
  Py_END_ALLOW_THREADS
  return PyBool_FromLong(ok);
}

PyObject* Pairer_push_frame(PairerObject* self, PyObject* args) {
  FrameMsg f;
  if (!PyArg_ParseTuple(args, "dL", &f.t, &f.handle)) return nullptr;
  bool ok;
  Py_BEGIN_ALLOW_THREADS
  ok = self->pairer->PushFrame(f);
  Py_END_ALLOW_THREADS
  return PyBool_FromLong(ok);
}

PyObject* Pairer_next(PairerObject* self, PyObject* args, PyObject* kwargs) {
  int wait = 0;
  static const char* kwlist[] = {"wait", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "|p",
                                   const_cast<char**>(kwlist), &wait))
    return nullptr;
  FrameMsg f;
  std::vector<ImuSample> batch;
  bool got;
  Py_BEGIN_ALLOW_THREADS
  got = self->pairer->Next(wait != 0, &f, &batch);
  Py_END_ALLOW_THREADS
  if (!got) Py_RETURN_NONE;

  PyObject* rows = PyList_New(static_cast<Py_ssize_t>(batch.size()));
  if (!rows) return nullptr;
  for (size_t i = 0; i < batch.size(); ++i) {
    const ImuSample& s = batch[i];
    PyObject* row = Py_BuildValue("(ddddddd)", s.t, s.acc[0], s.acc[1],
                                  s.acc[2], s.gyr[0], s.gyr[1], s.gyr[2]);
    if (!row) {
      Py_DECREF(rows);
      return nullptr;
    }
    PyList_SET_ITEM(rows, static_cast<Py_ssize_t>(i), row);
  }
  return Py_BuildValue("(dLN)", f.t, f.handle, rows);
}

PyObject* Pairer_stats(PairerObject* self, PyObject*) {
  int64_t imu, frames, imu_dis, frame_dis;
  size_t imu_q, frame_q;
  self->pairer->Stats(&imu, &frames, &imu_dis, &frame_dis, &imu_q, &frame_q);
  return Py_BuildValue("{s:L,s:L,s:L,s:L,s:n,s:n}", "imu_pushed", imu,
                       "frames_pushed", frames, "imu_disorder", imu_dis,
                       "frame_disorder", frame_dis,
                       "imu_queued", static_cast<Py_ssize_t>(imu_q),
                       "frames_queued", static_cast<Py_ssize_t>(frame_q));
}

PyObject* Pairer_close(PairerObject* self, PyObject*) {
  self->pairer->Close();
  Py_RETURN_NONE;
}

PyMethodDef Pairer_methods[] = {
    {"push_imu", reinterpret_cast<PyCFunction>(Pairer_push_imu),
     METH_VARARGS, "push_imu(t, ax, ay, az, gx, gy, gz) -> bool"},
    {"push_frame", reinterpret_cast<PyCFunction>(Pairer_push_frame),
     METH_VARARGS, "push_frame(t, handle) -> bool"},
    {"next", reinterpret_cast<PyCFunction>(Pairer_next),
     METH_VARARGS | METH_KEYWORDS,
     "next(wait=False) -> None | (t, handle, [(t,ax,ay,az,gx,gy,gz)...])"},
    {"stats", reinterpret_cast<PyCFunction>(Pairer_stats), METH_NOARGS,
     "queue statistics dict"},
    {"close", reinterpret_cast<PyCFunction>(Pairer_close), METH_NOARGS,
     "unblock waiters"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject PairerType = [] {
  PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0) "vio_native.MeasurementPairer"};
  t.tp_basicsize = sizeof(PairerObject);
  t.tp_flags = Py_TPFLAGS_DEFAULT;
  t.tp_doc = "Thread-safe IMU/image measurement pairing queue (C++)";
  t.tp_new = Pairer_new;
  t.tp_dealloc = reinterpret_cast<destructor>(Pairer_dealloc);
  t.tp_methods = Pairer_methods;
  return t;
}();

PyModuleDef module_def = {PyModuleDef_HEAD_INIT, "vio_native",
                          "C++ measurement runtime for vio_tpu", -1,
                          nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_vio_native(void) {
  if (PyType_Ready(&PairerType) < 0) return nullptr;
  PyObject* m = PyModule_Create(&module_def);
  if (!m) return nullptr;
  Py_INCREF(&PairerType);
  if (PyModule_AddObject(m, "MeasurementPairer",
                         reinterpret_cast<PyObject*>(&PairerType)) < 0) {
    Py_DECREF(&PairerType);
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
