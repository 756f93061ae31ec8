// The embeddable C ABI serving entry of the PyTorch port.
//
// A copy of deeprec_tpu/serving/native/processor.cc that starts the
// port's serving runtime: initialize() spawns one worker process,
// `python3 -m deeprec_tpu_torch.serving.worker <model_entry>`, with
// the model_config JSON in DEEPREC_MODEL_CONFIG (its "device", "cuda"
// by default, selects the card), reads the worker's "PORT <n>" line,
// and proxies each process() request over a loopback HTTP connection,
// the transport of the C client SDK (sdk/c/deeprec_client.c). An
// existing worker is attached instead with {"connect_host": ...,
// "connect_port": N} in model_config. Built with g++ at first use by
// deeprec_tpu_torch/serving/native/__init__.py.
//
// ABI (all exported with C linkage):
//   void* initialize(const char* model_entry, const char* model_config,
//                    int* state);                     // 0 ok, -1 fail
//   int process(void* model, const void* input, int input_size,
//               void** output, int* output_size);     // JSON in/out
//   int batch_process(void* model, const void* const* inputs,
//                     const int* input_sizes, int count,
//                     void** outputs, int* output_sizes);
//   int get_serving_model_info(void* model, void** output,
//                              int* output_size);     // /healthz JSON
//   int get_serving_endpoint(void* model, char* host, int host_buflen,
//                            int* port);              // worker address
//   void deinitialize(void* model);
//
// Outputs are malloc()-ed; the caller frees them.

#include <arpa/inet.h>
#include <netdb.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <sys/types.h>
#include <sys/wait.h>
#include <unistd.h>

#include <string>
#include <vector>

namespace {

struct Model {
  std::string host;
  int port = 0;
  int timeout_ms = 30000;
  pid_t worker_pid = -1;  // -1: connect mode (not our process)
  int stdin_fd = -1;      // closing it tells the worker to exit
};

// -- minimal JSON field extraction (our own config format only) ------------

bool json_str(const std::string& s, const char* key, std::string* out) {
  std::string pat = std::string("\"") + key + "\"";
  size_t k = s.find(pat);
  if (k == std::string::npos) return false;
  size_t c = s.find(':', k + pat.size());
  if (c == std::string::npos) return false;
  size_t q1 = s.find('"', c + 1);
  if (q1 == std::string::npos) return false;
  size_t q2 = s.find('"', q1 + 1);
  if (q2 == std::string::npos) return false;
  *out = s.substr(q1 + 1, q2 - q1 - 1);
  return true;
}

bool json_int(const std::string& s, const char* key, long* out) {
  std::string pat = std::string("\"") + key + "\"";
  size_t k = s.find(pat);
  if (k == std::string::npos) return false;
  size_t c = s.find(':', k + pat.size());
  if (c == std::string::npos) return false;
  char* end = nullptr;
  long v = strtol(s.c_str() + c + 1, &end, 10);
  if (end == s.c_str() + c + 1) return false;
  *out = v;
  return true;
}

// -- loopback HTTP (mirror of sdk/c/deeprec_client.c) ----------------------

int http_connect(const Model* m) {
  char portbuf[16];
  snprintf(portbuf, sizeof portbuf, "%d", m->port);
  struct addrinfo hints, *res = nullptr;
  memset(&hints, 0, sizeof hints);
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(m->host.c_str(), portbuf, &hints, &res) != 0 || !res)
    return -1;
  int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0) {
    freeaddrinfo(res);
    return -1;
  }
  struct timeval tv = {m->timeout_ms / 1000, (m->timeout_ms % 1000) * 1000};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
  if (connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    close(fd);
    freeaddrinfo(res);
    return -1;
  }
  freeaddrinfo(res);
  return fd;
}

int send_all(int fd, const char* p, size_t n) {
  while (n > 0) {
    ssize_t w = send(fd, p, n, 0);
    if (w <= 0) return -2;
    p += w;
    n -= (size_t)w;
  }
  return 0;
}

// One request; malloc()s the response body into *out.
int http_roundtrip(const Model* m, const char* method, const char* path,
                   const char* body, int body_len, void** out,
                   int* out_size) {
  *out = nullptr;
  *out_size = 0;
  int fd = http_connect(m);
  if (fd < 0) return -1;
  char head[512];
  int hn = snprintf(head, sizeof head,
                    "%s %s HTTP/1.1\r\n"
                    "Host: %s:%d\r\n"
                    "Content-Type: application/json\r\n"
                    "Content-Length: %d\r\n"
                    "Connection: close\r\n\r\n",
                    method, path, m->host.c_str(), m->port,
                    body ? body_len : 0);
  if (hn <= 0 || (size_t)hn >= sizeof head ||
      send_all(fd, head, (size_t)hn) != 0 ||
      (body && body_len && send_all(fd, body, (size_t)body_len) != 0)) {
    close(fd);
    return -2;
  }
  std::string resp;
  char chunk[4096];
  for (;;) {
    ssize_t r = recv(fd, chunk, sizeof chunk, 0);
    if (r < 0) {
      close(fd);
      return -3;
    }
    if (r == 0) break;
    resp.append(chunk, (size_t)r);
  }
  close(fd);
  int status = 0;
  if (sscanf(resp.c_str(), "HTTP/%*s %d", &status) != 1) return -3;
  size_t bs = resp.find("\r\n\r\n");
  if (bs == std::string::npos) return -3;
  bs += 4;
  size_t blen = resp.size() - bs;
  char* buf = (char*)malloc(blen + 1);
  if (!buf) return -3;
  memcpy(buf, resp.data() + bs, blen);
  buf[blen] = '\0';
  *out = buf;
  *out_size = (int)blen;
  return status == 200 ? 0 : -4;
}

}  // namespace

extern "C" {

void* initialize(const char* model_entry, const char* model_config,
                 int* state) {
  if (state) *state = -1;
  std::string cfg = model_config ? model_config : "{}";
  Model* m = new Model();

  long port = 0;
  if (json_int(cfg, "connect_port", &port)) {  // attach mode
    std::string host = "127.0.0.1";
    json_str(cfg, "connect_host", &host);
    m->host = host;
    m->port = (int)port;
  } else {  // spawn the serving worker
    std::string python = "python3";
    json_str(cfg, "python", &python);
    const char* env_py = getenv("DEEPREC_PYTHON");
    if (env_py && *env_py) python = env_py;

    int inpipe[2], outpipe[2];
    if (pipe(inpipe) != 0 || pipe(outpipe) != 0) {
      delete m;
      return nullptr;
    }
    pid_t pid = fork();
    if (pid < 0) {
      delete m;
      return nullptr;
    }
    if (pid == 0) {  // child -> worker
      dup2(inpipe[0], STDIN_FILENO);
      dup2(outpipe[1], STDOUT_FILENO);
      close(inpipe[0]);
      close(inpipe[1]);
      close(outpipe[0]);
      close(outpipe[1]);
      setenv("DEEPREC_MODEL_CONFIG", cfg.c_str(), 1);
      execlp(python.c_str(), python.c_str(), "-m",
             "deeprec_tpu_torch.serving.worker",
             model_entry ? model_entry : "", (char*)nullptr);
      _exit(127);
    }
    close(inpipe[0]);
    close(outpipe[1]);
    m->worker_pid = pid;
    m->stdin_fd = inpipe[1];
    // Wait for the "PORT <n>" handshake (the restore and the kernels'
    // build can be slow; the child exiting breaks out on failure).
    std::string line;
    char ch;
    long got_port = -1;
    while (got_port < 0) {
      ssize_t r = read(outpipe[0], &ch, 1);
      if (r <= 0) break;
      if (ch == '\n') {
        if (sscanf(line.c_str(), "PORT %ld", &got_port) == 1) break;
        line.clear();
      } else {
        line += ch;
      }
    }
    close(outpipe[0]);
    if (got_port < 0) {
      kill(pid, SIGKILL);
      waitpid(pid, nullptr, 0);
      close(m->stdin_fd);
      delete m;
      return nullptr;
    }
    m->host = "127.0.0.1";
    m->port = (int)got_port;
  }
  long t;
  if (json_int(cfg, "timeout_ms", &t)) m->timeout_ms = (int)t;
  if (state) *state = 0;
  return m;
}

int process(void* model_buf, const void* input_data, int input_size,
            void** output_data, int* output_size) {
  if (!model_buf || !output_data || !output_size) return -1;
  Model* m = (Model*)model_buf;
  return http_roundtrip(m, "POST", "/v1/predict",
                        (const char*)input_data, input_size, output_data,
                        output_size);
}

int batch_process(void* model_buf, const void* const* input_datas,
                  const int* input_sizes, int count, void** output_datas,
                  int* output_sizes) {
  if (!model_buf || count < 0) return -1;
  int rc = 0;
  for (int i = 0; i < count; ++i) {
    int r = process(model_buf, input_datas[i], input_sizes[i],
                    &output_datas[i], &output_sizes[i]);
    if (r != 0 && rc == 0) rc = r;
  }
  return rc;
}

int get_serving_endpoint(void* model_buf, char* host_buf,
                         int host_buflen, int* port) {
  // Extension over the reference ABI: expose the worker's loopback
  // endpoint so hosts can wire their own transports/health checks
  // (e.g. the C client SDK) straight to the serving runtime.
  if (!model_buf || !host_buf || host_buflen <= 0 || !port) return -1;
  Model* m = (Model*)model_buf;
  if ((int)m->host.size() + 1 > host_buflen) return -5;
  memcpy(host_buf, m->host.c_str(), m->host.size() + 1);
  *port = m->port;
  return 0;
}

int get_serving_model_info(void* model_buf, void** output_data,
                           int* output_size) {
  if (!model_buf) return -1;
  Model* m = (Model*)model_buf;
  return http_roundtrip(m, "GET", "/healthz", nullptr, 0, output_data,
                        output_size);
}

void deinitialize(void* model_buf) {
  if (!model_buf) return;
  Model* m = (Model*)model_buf;
  if (m->stdin_fd >= 0) close(m->stdin_fd);  // EOF -> worker exits
  if (m->worker_pid > 0) {
    // Give it a moment, then make sure.
    int status;
    for (int i = 0; i < 50; ++i) {
      if (waitpid(m->worker_pid, &status, WNOHANG) == m->worker_pid) {
        m->worker_pid = -1;
        break;
      }
      usleep(100 * 1000);
    }
    if (m->worker_pid > 0) {
      kill(m->worker_pid, SIGTERM);
      waitpid(m->worker_pid, &status, 0);
    }
  }
  delete m;
}

}  // extern "C"
