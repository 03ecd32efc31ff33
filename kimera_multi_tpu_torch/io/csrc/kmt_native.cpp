// kmt_native: native runtime support for kimera_multi_tpu.
//
// Role of the reference's native glue layers (SURVEY.md section 2.1):
//   * pose_graph_tools' message definitions/serialization -> a compact
//     binary wire format for PoseGraph edges and VLC frames (DCN
//     transport between pods, on-disk keyframe logs);
//   * Kimera-VIO's ThreadsafeQueue (images/kimera-multi.drawio:1363) and
//     RosbagDataProvider (drawio:834-863) -> a background-thread replayer
//     that decodes keyframe packets from disk into a bounded ring buffer
//     while the accelerator computes (host IO/compute overlap).
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (kimera_multi_tpu/io/native.py). No Python.h dependency.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// wire format
// ---------------------------------------------------------------------
// Everything little-endian. One "packet" is:
//   magic u32 'KMT1' | type u8 | payload_len u32 | payload
// Edge payload (type 1): src_robot i32, src_pose i32, dst_robot i32,
//   dst_pose i32, etype i32, kappa f32, tau f32, R f32[9], t f32[3]
// VLC frame payload (type 2): robot i32, frame i32, n_feats i32,
//   then n_feats * (desc u8[32], bearing f32[3], landmark f32[3],
//   valid u8, has_depth u8)

constexpr uint32_t kMagic = 0x314B4D54;  // "TMK1" little-endian view
constexpr uint8_t kTypeEdge = 1;
constexpr uint8_t kTypeVlc = 2;

struct Buffer {
  std::vector<uint8_t> data;
  size_t read_pos = 0;
};

void put_bytes(Buffer* b, const void* p, size_t n) {
  const uint8_t* s = static_cast<const uint8_t*>(p);
  b->data.insert(b->data.end(), s, s + n);
}

template <typename T>
void put(Buffer* b, T v) {
  put_bytes(b, &v, sizeof(T));
}

bool get_bytes(Buffer* b, void* p, size_t n) {
  if (b->read_pos + n > b->data.size()) return false;
  std::memcpy(p, b->data.data() + b->read_pos, n);
  b->read_pos += n;
  return true;
}

template <typename T>
bool get(Buffer* b, T* v) {
  return get_bytes(b, v, sizeof(T));
}

struct EdgeRec {
  int32_t src_robot, src_pose, dst_robot, dst_pose, etype;
  float kappa, tau;
  float R[9];
  float t[3];
};

struct VlcHeader {
  int32_t robot, frame, n_feats;
};

void write_packet(Buffer* b, uint8_t type, const Buffer& payload) {
  put<uint32_t>(b, kMagic);
  put<uint8_t>(b, type);
  put<uint32_t>(b, static_cast<uint32_t>(payload.data.size()));
  put_bytes(b, payload.data.data(), payload.data.size());
}

// ---------------------------------------------------------------------
// replayer: background decode thread + bounded queue
// ---------------------------------------------------------------------

struct Packet {
  uint8_t type;
  int32_t conn = -1;  // receiving connection id (DCN peer only)
  std::vector<uint8_t> payload;
};

class Replayer {
 public:
  Replayer(const std::string& path, size_t queue_capacity)
      : capacity_(queue_capacity), done_(false), error_(false) {
    worker_ = std::thread([this, path] { this->run(path); });
  }
  ~Replayer() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_pop_.notify_all();
    cv_push_.notify_all();
    if (worker_.joinable()) worker_.join();
  }

  // Pops the next packet; returns false when the stream is exhausted.
  bool pop(Packet* out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_pop_.wait(lk, [this] { return !q_.empty() || done_ || stop_; });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop();
    cv_push_.notify_one();
    return true;
  }

  bool error() const { return error_.load(); }

 private:
  void run(const std::string& path) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) {
      error_ = true;
      finish();
      return;
    }
    while (true) {
      uint32_t magic = 0;
      if (std::fread(&magic, 4, 1, f) != 1) break;
      if (magic != kMagic) {
        error_ = true;
        break;
      }
      uint8_t type = 0;
      uint32_t len = 0;
      if (std::fread(&type, 1, 1, f) != 1 ||
          std::fread(&len, 4, 1, f) != 1) {
        error_ = true;
        break;
      }
      Packet p;
      p.type = type;
      p.payload.resize(len);
      if (len && std::fread(p.payload.data(), 1, len, f) != len) {
        error_ = true;
        break;
      }
      std::unique_lock<std::mutex> lk(mu_);
      cv_push_.wait(lk, [this] { return q_.size() < capacity_ || stop_; });
      if (stop_) break;
      q_.push(std::move(p));
      cv_pop_.notify_one();
    }
    std::fclose(f);
    finish();
  }

  void finish() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      done_ = true;
    }
    cv_pop_.notify_all();
  }

  size_t capacity_;
  std::queue<Packet> q_;
  std::mutex mu_;
  std::condition_variable cv_pop_, cv_push_;
  std::thread worker_;
  bool stop_ = false;
  bool done_;
  std::atomic<bool> error_;
};

// ---------------------------------------------------------------------
// DCN peer: TCP transport between pods.
// ---------------------------------------------------------------------
// Role of the reference deployment's inter-robot mesh-network layer (the
// "remote topic manager" carrying BoW vectors, VLC frames, pose graphs
// and dpgo status between machines — reference README.md:129,139,153-154).
// Packets reuse the wire format above; TCP gives reliability/ordering
// (the reference leans on the same from its transport), the bounded recv
// queue gives end-to-end backpressure (the kernel stops ACKing once the
// consumer falls behind — the chunked-gather flow-control analogue), and
// atomic byte counters match dpgo_ros's mTotalBytesReceived accounting.

class Peer {
 public:
  Peer(int32_t port, size_t queue_capacity, bool loopback_only)
      : capacity_(queue_capacity) {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return;
    int one = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    // loopback for same-host pods; INADDR_ANY for real cross-machine DCN
    addr.sin_addr.s_addr =
        htonl(loopback_only ? INADDR_LOOPBACK : INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr),
               sizeof(addr)) != 0 ||
        ::listen(listen_fd_, 16) != 0) {
      ::close(listen_fd_);
      listen_fd_ = -1;
      return;
    }
    socklen_t alen = sizeof(addr);
    ::getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &alen);
    port_ = ntohs(addr.sin_port);
    accept_thread_ = std::thread([this] { this->accept_loop(); });
  }

  ~Peer() { close(); }

  void close() {
    bool expected = false;
    if (!stop_.compare_exchange_strong(expected, true)) return;
    if (listen_fd_ >= 0) ::shutdown(listen_fd_, SHUT_RDWR);
    if (accept_thread_.joinable()) accept_thread_.join();
    {
      std::lock_guard<std::mutex> lk(conn_mu_);
      for (int fd : conns_)
        if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
    }
    cv_pop_.notify_all();
    cv_push_.notify_all();
    for (auto& t : recv_threads_)
      if (t.joinable()) t.join();
    if (listen_fd_ >= 0) ::close(listen_fd_);
    std::lock_guard<std::mutex> lk(conn_mu_);
    for (int fd : conns_)
      if (fd >= 0) ::close(fd);
    conns_.clear();
  }

  int32_t port() const { return port_; }
  bool ok() const { return listen_fd_ >= 0; }

  int32_t connect_to(const char* host, int32_t port) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
      ::close(fd);
      return -1;
    }
    if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) !=
        0) {
      ::close(fd);
      return -1;
    }
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    return add_conn(fd);
  }

  int32_t n_conns() {
    std::lock_guard<std::mutex> lk(conn_mu_);
    int32_t n = 0;
    for (int fd : conns_)
      if (fd >= 0) ++n;
    return n;
  }

  // Sends raw framed bytes on one connection (conn >= 0) or every live
  // connection (conn == -1). Writes in 256 KiB chunks (the chunked-gather
  // discipline: one oversized message never monopolizes the send path).
  int64_t send(int32_t conn, const uint8_t* data, uint64_t n) {
    std::vector<int> targets;
    {
      std::lock_guard<std::mutex> lk(conn_mu_);
      if (conn >= 0) {
        if (conn >= static_cast<int32_t>(conns_.size()) ||
            conns_[conn] < 0)
          return -1;
        targets.push_back(conns_[conn]);
      } else {
        for (int fd : conns_)
          if (fd >= 0) targets.push_back(fd);
      }
    }
    int64_t total = 0;
    constexpr uint64_t kChunk = 256 * 1024;
    for (int fd : targets) {
      std::lock_guard<std::mutex> lk(send_mu_);
      uint64_t off = 0;
      while (off < n) {
        uint64_t len = n - off < kChunk ? n - off : kChunk;
        ssize_t w = ::send(fd, data + off, len, MSG_NOSIGNAL);
        if (w <= 0) return -1;
        off += static_cast<uint64_t>(w);
        bytes_sent_ += w;
        total += w;
      }
    }
    return total;
  }

  // Pops the next packet (framed: header+payload) into out. Returns the
  // packet type, 0 on timeout, -1 when all connections are closed and the
  // queue is drained. conn_out (optional) receives the id of the
  // connection the packet arrived on — per-connection TCP FIFO plus this
  // identity is what lets the DCN layer attribute packets to senders and
  // keep multi-pod rounds ordered (dist/dcn.py collect()).
  int32_t recv(std::vector<uint8_t>* out, int32_t timeout_ms,
               int32_t* conn_out = nullptr) {
    std::unique_lock<std::mutex> lk(mu_);
    // "dead" only once at least one connection existed and all are gone —
    // a freshly bound peer waiting for inbound connects is just idle
    auto dead = [this] { return had_readers_ && live_readers_ == 0; };
    auto ready = [this, dead] { return !q_.empty() || stop_ || dead(); };
    if (timeout_ms < 0) {
      cv_pop_.wait(lk, ready);
    } else if (!cv_pop_.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                 ready)) {
      return 0;
    }
    if (q_.empty()) return (stop_ || dead()) ? -1 : 0;
    Packet p = std::move(q_.front());
    q_.pop();
    cv_push_.notify_one();
    lk.unlock();
    if (conn_out) *conn_out = p.conn;
    Buffer framed;
    Buffer payload;
    payload.data = std::move(p.payload);
    write_packet(&framed, p.type, payload);
    *out = std::move(framed.data);
    return p.type;
  }

  int64_t bytes_sent() const { return bytes_sent_.load(); }
  int64_t bytes_received() const { return bytes_received_.load(); }

 private:
  int32_t add_conn(int fd) {
    std::lock_guard<std::mutex> lk(conn_mu_);
    conns_.push_back(fd);
    int32_t id = static_cast<int32_t>(conns_.size()) - 1;
    {
      std::lock_guard<std::mutex> qlk(mu_);
      ++live_readers_;
      had_readers_ = true;
    }
    recv_threads_.emplace_back([this, fd, id] { this->recv_loop(fd, id); });
    return id;
  }

  void accept_loop() {
    while (!stop_) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) break;
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      add_conn(fd);
    }
  }

  bool read_exact(int fd, void* p, size_t n) {
    uint8_t* dst = static_cast<uint8_t*>(p);
    size_t got = 0;
    while (got < n) {
      ssize_t r = ::recv(fd, dst + got, n - got, 0);
      if (r <= 0) return false;
      got += static_cast<size_t>(r);
      bytes_received_ += r;
    }
    return true;
  }

  void recv_loop(int fd, int32_t conn_id) {
    while (!stop_) {
      uint32_t magic = 0, len = 0;
      uint8_t type = 0;
      if (!read_exact(fd, &magic, 4) || magic != kMagic ||
          !read_exact(fd, &type, 1) || !read_exact(fd, &len, 4))
        break;
      Packet p;
      p.type = type;
      p.conn = conn_id;
      p.payload.resize(len);
      if (len && !read_exact(fd, p.payload.data(), len)) break;
      std::unique_lock<std::mutex> lk(mu_);
      // backpressure: stop draining the socket (and thus stop the TCP
      // window) until the consumer catches up
      cv_push_.wait(lk, [this] { return q_.size() < capacity_ || stop_; });
      if (stop_) break;
      q_.push(std::move(p));
      cv_pop_.notify_one();
    }
    std::lock_guard<std::mutex> lk(mu_);
    --live_readers_;
    cv_pop_.notify_all();
  }

  int listen_fd_ = -1;
  int32_t port_ = -1;
  size_t capacity_;
  std::atomic<bool> stop_{false};
  std::atomic<int64_t> bytes_sent_{0};
  std::atomic<int64_t> bytes_received_{0};
  std::mutex conn_mu_, send_mu_, mu_;
  std::vector<int> conns_;
  std::vector<std::thread> recv_threads_;
  std::thread accept_thread_;
  std::queue<Packet> q_;
  int live_readers_ = 0;  // guarded by mu_
  bool had_readers_ = false;  // guarded by mu_
  std::condition_variable cv_pop_, cv_push_;
};

}  // namespace

// ---------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------

extern "C" {

// ---- serialization ---------------------------------------------------

void* kmt_buffer_new() { return new Buffer(); }
void kmt_buffer_free(void* b) { delete static_cast<Buffer*>(b); }
const uint8_t* kmt_buffer_data(void* b) {
  return static_cast<Buffer*>(b)->data.data();
}
uint64_t kmt_buffer_size(void* b) {
  return static_cast<Buffer*>(b)->data.size();
}
void kmt_buffer_load(void* b, const uint8_t* data, uint64_t n) {
  Buffer* buf = static_cast<Buffer*>(b);
  buf->data.assign(data, data + n);
  buf->read_pos = 0;
}

void kmt_write_edges(void* b, int32_t n, const int32_t* src_robot,
                     const int32_t* src_pose, const int32_t* dst_robot,
                     const int32_t* dst_pose, const int32_t* etype,
                     const float* kappa, const float* tau, const float* R,
                     const float* t) {
  Buffer* out = static_cast<Buffer*>(b);
  for (int32_t i = 0; i < n; ++i) {
    Buffer payload;
    EdgeRec e;
    e.src_robot = src_robot[i];
    e.src_pose = src_pose[i];
    e.dst_robot = dst_robot[i];
    e.dst_pose = dst_pose[i];
    e.etype = etype[i];
    e.kappa = kappa[i];
    e.tau = tau[i];
    std::memcpy(e.R, R + 9 * i, 9 * sizeof(float));
    std::memcpy(e.t, t + 3 * i, 3 * sizeof(float));
    put(&payload, e);
    write_packet(out, kTypeEdge, payload);
  }
}

// Reads up to max_n edges from the buffer; returns the number read.
int32_t kmt_read_edges(void* b, int32_t max_n, int32_t* src_robot,
                       int32_t* src_pose, int32_t* dst_robot,
                       int32_t* dst_pose, int32_t* etype, float* kappa,
                       float* tau, float* R, float* t) {
  Buffer* in = static_cast<Buffer*>(b);
  int32_t count = 0;
  while (count < max_n) {
    size_t mark = in->read_pos;
    uint32_t magic;
    uint8_t type;
    uint32_t len;
    if (!get(in, &magic) || magic != kMagic || !get(in, &type) ||
        !get(in, &len)) {
      in->read_pos = mark;
      break;
    }
    if (type != kTypeEdge) {  // skip foreign packets
      in->read_pos += len;
      continue;
    }
    EdgeRec e;
    if (!get(in, &e)) {
      in->read_pos = mark;
      break;
    }
    src_robot[count] = e.src_robot;
    src_pose[count] = e.src_pose;
    dst_robot[count] = e.dst_robot;
    dst_pose[count] = e.dst_pose;
    etype[count] = e.etype;
    kappa[count] = e.kappa;
    tau[count] = e.tau;
    std::memcpy(R + 9 * count, e.R, 9 * sizeof(float));
    std::memcpy(t + 3 * count, e.t, 3 * sizeof(float));
    ++count;
  }
  return count;
}

void kmt_write_vlc(void* b, int32_t robot, int32_t frame, int32_t n_feats,
                   const uint8_t* desc, const float* bearings,
                   const float* landmarks, const uint8_t* valid,
                   const uint8_t* has_depth) {
  Buffer* out = static_cast<Buffer*>(b);
  Buffer payload;
  VlcHeader h{robot, frame, n_feats};
  put(&payload, h);
  for (int32_t i = 0; i < n_feats; ++i) {
    put_bytes(&payload, desc + 32 * i, 32);
    put_bytes(&payload, bearings + 3 * i, 12);
    put_bytes(&payload, landmarks + 3 * i, 12);
    put<uint8_t>(&payload, valid[i]);
    put<uint8_t>(&payload, has_depth[i]);
  }
  write_packet(out, kTypeVlc, payload);
}

// Reads one VLC frame (up to max_feats); returns n_feats or -1.
int32_t kmt_read_vlc(void* b, int32_t max_feats, int32_t* robot,
                     int32_t* frame, uint8_t* desc, float* bearings,
                     float* landmarks, uint8_t* valid, uint8_t* has_depth) {
  Buffer* in = static_cast<Buffer*>(b);
  while (true) {
    size_t mark = in->read_pos;
    uint32_t magic;
    uint8_t type;
    uint32_t len;
    if (!get(in, &magic) || magic != kMagic || !get(in, &type) ||
        !get(in, &len)) {
      in->read_pos = mark;
      return -1;
    }
    if (type != kTypeVlc) {
      in->read_pos += len;
      continue;
    }
    VlcHeader h;
    if (!get(in, &h)) return -1;
    *robot = h.robot;
    *frame = h.frame;
    int32_t n = h.n_feats < max_feats ? h.n_feats : max_feats;
    for (int32_t i = 0; i < h.n_feats; ++i) {
      uint8_t d[32], v, hd;
      float be[3], lm[3];
      if (!get_bytes(in, d, 32) || !get_bytes(in, be, 12) ||
          !get_bytes(in, lm, 12) || !get(in, &v) || !get(in, &hd))
        return -1;
      if (i < n) {
        std::memcpy(desc + 32 * i, d, 32);
        std::memcpy(bearings + 3 * i, be, 12);
        std::memcpy(landmarks + 3 * i, lm, 12);
        valid[i] = v;
        has_depth[i] = hd;
      }
    }
    return n;
  }
}

// Frames an arbitrary payload (types beyond edge/VLC are defined by the
// Python schema layer: 3 = control/barrier, 4 = tensor block).
void kmt_write_raw(void* b, uint8_t type, const uint8_t* payload,
                   uint32_t n) {
  Buffer* out = static_cast<Buffer*>(b);
  Buffer p;
  p.data.assign(payload, payload + n);
  write_packet(out, type, p);
}

int32_t kmt_buffer_write_file(void* b, const char* path) {
  Buffer* buf = static_cast<Buffer*>(b);
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  size_t n = std::fwrite(buf->data.data(), 1, buf->data.size(), f);
  std::fclose(f);
  return n == buf->data.size() ? 0 : -1;
}

// ---- DCN peer --------------------------------------------------------

// Binds a TCP listener (port 0 = ephemeral; loopback_only != 0 restricts
// to 127.0.0.1). queue_capacity bounds the receive queue in packets
// (backpressure past that).
void* kmt_peer_new(int32_t port, int32_t queue_capacity,
                   int32_t loopback_only) {
  Peer* p = new Peer(port, static_cast<size_t>(queue_capacity),
                     loopback_only != 0);
  if (!p->ok()) {
    delete p;
    return nullptr;
  }
  return p;
}
void kmt_peer_close(void* p) { delete static_cast<Peer*>(p); }
int32_t kmt_peer_port(void* p) { return static_cast<Peer*>(p)->port(); }
int32_t kmt_peer_connect(void* p, const char* host, int32_t port) {
  return static_cast<Peer*>(p)->connect_to(host, port);
}
int32_t kmt_peer_n_conns(void* p) {
  return static_cast<Peer*>(p)->n_conns();
}

// Sends the buffer's framed packets on connection `conn` (-1 = all).
// Returns total bytes written or -1.
int64_t kmt_peer_send(void* p, int32_t conn, void* buffer) {
  Buffer* b = static_cast<Buffer*>(buffer);
  return static_cast<Peer*>(p)->send(conn, b->data.data(), b->data.size());
}

// Pops the next packet into buffer_out (full frame, ready for the
// kmt_read_* decoders). Returns the packet type, 0 on timeout, -1 when
// every connection has closed and the queue is drained.
int32_t kmt_peer_recv(void* p, void* buffer_out, int32_t timeout_ms) {
  Buffer* b = static_cast<Buffer*>(buffer_out);
  std::vector<uint8_t> framed;
  int32_t t = static_cast<Peer*>(p)->recv(&framed, timeout_ms);
  if (t > 0) {
    b->data = std::move(framed);
    b->read_pos = 0;
  }
  return t;
}

// Like kmt_peer_recv but also reports the receiving connection id in
// *conn_out — the sender-attribution primitive for multi-pod rounds.
int32_t kmt_peer_recv_from(void* p, void* buffer_out, int32_t timeout_ms,
                           int32_t* conn_out) {
  Buffer* b = static_cast<Buffer*>(buffer_out);
  std::vector<uint8_t> framed;
  int32_t conn = -1;
  int32_t t = static_cast<Peer*>(p)->recv(&framed, timeout_ms, &conn);
  if (t > 0) {
    b->data = std::move(framed);
    b->read_pos = 0;
  }
  if (conn_out) *conn_out = conn;
  return t;
}

int64_t kmt_peer_bytes_sent(void* p) {
  return static_cast<Peer*>(p)->bytes_sent();
}
int64_t kmt_peer_bytes_received(void* p) {
  return static_cast<Peer*>(p)->bytes_received();
}

// ---- replayer --------------------------------------------------------

void* kmt_replayer_open(const char* path, int32_t queue_capacity) {
  return new Replayer(path, static_cast<size_t>(queue_capacity));
}
void kmt_replayer_close(void* r) { delete static_cast<Replayer*>(r); }

// Pops the next packet into the provided buffer; returns the packet type,
// 0 at end of stream, -1 on stream error.
int32_t kmt_replayer_pop(void* r, void* buffer_out) {
  Replayer* rep = static_cast<Replayer*>(r);
  Packet p;
  if (!rep->pop(&p)) return rep->error() ? -1 : 0;
  Buffer* b = static_cast<Buffer*>(buffer_out);
  b->data.clear();
  b->read_pos = 0;
  Buffer payload;
  payload.data = std::move(p.payload);
  write_packet(b, p.type, payload);
  return p.type;
}

}  // extern "C"
