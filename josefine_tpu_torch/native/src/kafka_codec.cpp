// Kafka wire-protocol codec (native).
//
// The TPU build's equivalent of the reference's kafka-protocol crate +
// codec layer (/root/reference/src/kafka/codec.rs: server decode/encode
// :31-149, client correlation handling :151-276, 4-byte length framing
// :22-29). Schema-table driven, like the crate: each API version is a
// declarative field table (type + version range) walked by a generic
// reader/writer, including flexible-version (compact/tagged-field)
// encodings.
//
// Deliberate upgrades over the reference (SURVEY.md quirk 8): LeaderAndIsr,
// Produce and Fetch are fully wire-decodable here (the reference advertises
// them but cannot decode them, so its Produce path and remote LeaderAndIsr
// fan-out are unreachable).
//
// Python surface:
//   decode_request(payload)  -> {api_key, api_version, correlation_id,
//                                client_id, body}
//   encode_response(api_key, api_version, correlation_id, body) -> bytes
//   encode_request(api_key, api_version, correlation_id, client_id, body)
//                            -> bytes
//   decode_response(api_key, api_version, payload) -> {correlation_id, body}
//   supported_apis()         -> [(api_key, min_version, max_version)]
// Payloads exclude the 4-byte length frame (the transport owns framing).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ------------------------------------------------------------- api keys
enum ApiKey : int16_t {
  API_PRODUCE = 0,
  API_FETCH = 1,
  API_LIST_OFFSETS = 2,
  API_METADATA = 3,
  API_LEADER_AND_ISR = 4,
  API_OFFSET_COMMIT = 8,
  API_OFFSET_FETCH = 9,
  API_FIND_COORDINATOR = 10,
  API_JOIN_GROUP = 11,
  API_HEARTBEAT = 12,
  API_LEAVE_GROUP = 13,
  API_SYNC_GROUP = 14,
  API_DESCRIBE_GROUPS = 15,
  API_LIST_GROUPS = 16,
  API_API_VERSIONS = 18,
  API_CREATE_TOPICS = 19,
  API_DELETE_TOPICS = 20,
  API_INIT_PRODUCER_ID = 22,
};

struct ApiRange { int16_t key, min_ver, max_ver, flexible_from; };

// Supported version windows. flexible_from is the protocol's threshold for
// compact/tagged encodings (affects header + body layout).
const ApiRange API_RANGES[] = {
    {API_PRODUCE, 2, 8, 9},
    {API_FETCH, 4, 6, 12},
    {API_LIST_OFFSETS, 1, 2, 6},
    {API_METADATA, 0, 5, 9},
    {API_LEADER_AND_ISR, 0, 0, 4},
    {API_OFFSET_COMMIT, 2, 3, 8},
    {API_OFFSET_FETCH, 1, 3, 6},
    {API_FIND_COORDINATOR, 0, 2, 3},
    {API_JOIN_GROUP, 0, 2, 6},
    {API_HEARTBEAT, 0, 1, 4},
    {API_LEAVE_GROUP, 0, 1, 4},
    {API_SYNC_GROUP, 0, 1, 4},
    {API_DESCRIBE_GROUPS, 0, 1, 5},
    {API_LIST_GROUPS, 0, 2, 3},
    {API_API_VERSIONS, 0, 3, 3},
    {API_CREATE_TOPICS, 0, 2, 5},
    {API_DELETE_TOPICS, 0, 1, 4},
    {API_INIT_PRODUCER_ID, 0, 1, 2},
};

const ApiRange* find_api(int16_t key) {
  for (const auto& r : API_RANGES)
    if (r.key == key) return &r;
  return nullptr;
}

// ------------------------------------------------------------ buffers
struct Reader {
  const uint8_t* p;
  size_t n, pos = 0;
  bool ok = true;
  std::string err;

  Reader(const uint8_t* buf, size_t len) : p(buf), n(len) {}

  bool need(size_t k) {
    if (!ok) return false;
    if (pos + k > n) { ok = false; err = "buffer underflow"; return false; }
    return true;
  }
  uint8_t u8() { if (!need(1)) return 0; return p[pos++]; }
  int8_t i8() { return (int8_t)u8(); }
  int16_t i16() { if (!need(2)) return 0; int16_t v = (int16_t)((p[pos] << 8) | p[pos+1]); pos += 2; return v; }
  int32_t i32() {
    if (!need(4)) return 0;
    uint32_t v = ((uint32_t)p[pos] << 24) | ((uint32_t)p[pos+1] << 16) |
                 ((uint32_t)p[pos+2] << 8) | p[pos+3];
    pos += 4;
    return (int32_t)v;
  }
  int64_t i64() {
    uint64_t hi = (uint32_t)i32(), lo = (uint32_t)i32();
    return (int64_t)((hi << 32) | lo);
  }
  uint32_t uvarint() {
    uint32_t v = 0; int shift = 0;
    while (true) {
      if (!need(1)) return 0;
      uint8_t b = p[pos++];
      v |= (uint32_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 28) { ok = false; err = "uvarint too long"; return 0; }
    }
  }
  const uint8_t* raw(size_t k) {
    if (!need(k)) return nullptr;
    const uint8_t* r = p + pos;
    pos += k;
    return r;
  }
  void skip_tagged() {
    uint32_t cnt = uvarint();
    for (uint32_t i = 0; i < cnt && ok; i++) {
      uvarint();  // tag
      uint32_t sz = uvarint();
      raw(sz);
    }
  }
};

struct Writer {
  std::vector<uint8_t> buf;

  void u8(uint8_t v) { buf.push_back(v); }
  void i16(int16_t v) { buf.push_back((uint16_t)v >> 8); buf.push_back((uint8_t)v); }
  void i32(int32_t v) {
    uint32_t u = (uint32_t)v;
    buf.push_back(u >> 24); buf.push_back(u >> 16); buf.push_back(u >> 8); buf.push_back(u);
  }
  void i64(int64_t v) { i32((int32_t)((uint64_t)v >> 32)); i32((int32_t)v); }
  void uvarint(uint32_t v) {
    while (v >= 0x80) { buf.push_back((uint8_t)(v | 0x80)); v >>= 7; }
    buf.push_back((uint8_t)v);
  }
  void raw(const void* d, size_t k) {
    const uint8_t* q = (const uint8_t*)d;
    buf.insert(buf.end(), q, q + k);
  }
  void tagged() { uvarint(0); }
};

// ------------------------------------------------------------- schemas
enum FType : uint8_t {
  T_BOOL, T_INT8, T_INT16, T_INT32, T_INT64,
  T_STRING, T_NSTRING,   // string / nullable string
  T_BYTES, T_NBYTES,     // bytes / nullable bytes
  T_ARRAY, T_NARRAY,     // array of structs / nullable array of structs
  T_INT32S,              // array of int32
  T_STRINGS,             // array of string
};

struct Schema;
struct Field {
  const char* name;
  FType type;
  int8_t min_ver;
  int8_t max_ver;
  const Schema* sub;  // element schema for T_ARRAY/T_NARRAY
};
struct Schema {
  const Field* fields;
  int nfields;
};

#define FLD(...) __VA_ARGS__
#define SCHEMA(name, ...)                                   \
  const Field name##_fields[] = {__VA_ARGS__};              \
  const Schema name = {name##_fields,                       \
                       (int)(sizeof(name##_fields) / sizeof(Field))};

// -- Produce (request v2-v8; fields cite kafka protocol, not the reference)
SCHEMA(PRODUCE_REQ_PART,
  FLD({"index", T_INT32, 0, 127, nullptr}),
  FLD({"records", T_NBYTES, 0, 127, nullptr}))
SCHEMA(PRODUCE_REQ_TOPIC,
  FLD({"name", T_STRING, 0, 127, nullptr}),
  FLD({"partitions", T_ARRAY, 0, 127, &PRODUCE_REQ_PART}))
SCHEMA(PRODUCE_REQ,
  FLD({"transactional_id", T_NSTRING, 3, 127, nullptr}),
  FLD({"acks", T_INT16, 0, 127, nullptr}),
  FLD({"timeout_ms", T_INT32, 0, 127, nullptr}),
  FLD({"topics", T_ARRAY, 0, 127, &PRODUCE_REQ_TOPIC}))
SCHEMA(PRODUCE_RESP_PART,
  FLD({"index", T_INT32, 0, 127, nullptr}),
  FLD({"error_code", T_INT16, 0, 127, nullptr}),
  FLD({"base_offset", T_INT64, 0, 127, nullptr}),
  FLD({"log_append_time_ms", T_INT64, 2, 127, nullptr}),
  FLD({"log_start_offset", T_INT64, 5, 127, nullptr}))
SCHEMA(PRODUCE_RESP_TOPIC,
  FLD({"name", T_STRING, 0, 127, nullptr}),
  FLD({"partitions", T_ARRAY, 0, 127, &PRODUCE_RESP_PART}))
SCHEMA(PRODUCE_RESP,
  FLD({"responses", T_ARRAY, 0, 127, &PRODUCE_RESP_TOPIC}),
  FLD({"throttle_time_ms", T_INT32, 1, 127, nullptr}))

// -- Fetch (v4-v6)
SCHEMA(FETCH_REQ_PART,
  FLD({"partition", T_INT32, 0, 127, nullptr}),
  FLD({"fetch_offset", T_INT64, 0, 127, nullptr}),
  FLD({"log_start_offset", T_INT64, 5, 127, nullptr}),
  FLD({"partition_max_bytes", T_INT32, 0, 127, nullptr}))
SCHEMA(FETCH_REQ_TOPIC,
  FLD({"topic", T_STRING, 0, 127, nullptr}),
  FLD({"partitions", T_ARRAY, 0, 127, &FETCH_REQ_PART}))
SCHEMA(FETCH_REQ,
  FLD({"replica_id", T_INT32, 0, 127, nullptr}),
  FLD({"max_wait_ms", T_INT32, 0, 127, nullptr}),
  FLD({"min_bytes", T_INT32, 0, 127, nullptr}),
  FLD({"max_bytes", T_INT32, 3, 127, nullptr}),
  FLD({"isolation_level", T_INT8, 4, 127, nullptr}),
  FLD({"topics", T_ARRAY, 0, 127, &FETCH_REQ_TOPIC}))
SCHEMA(ABORTED_TXN,
  FLD({"producer_id", T_INT64, 0, 127, nullptr}),
  FLD({"first_offset", T_INT64, 0, 127, nullptr}))
SCHEMA(FETCH_RESP_PART,
  FLD({"partition", T_INT32, 0, 127, nullptr}),
  FLD({"error_code", T_INT16, 0, 127, nullptr}),
  FLD({"high_watermark", T_INT64, 0, 127, nullptr}),
  FLD({"last_stable_offset", T_INT64, 4, 127, nullptr}),
  FLD({"log_start_offset", T_INT64, 5, 127, nullptr}),
  FLD({"aborted_transactions", T_NARRAY, 4, 127, &ABORTED_TXN}),
  FLD({"records", T_NBYTES, 0, 127, nullptr}))
SCHEMA(FETCH_RESP_TOPIC,
  FLD({"topic", T_STRING, 0, 127, nullptr}),
  FLD({"partitions", T_ARRAY, 0, 127, &FETCH_RESP_PART}))
SCHEMA(FETCH_RESP,
  FLD({"throttle_time_ms", T_INT32, 1, 127, nullptr}),
  FLD({"responses", T_ARRAY, 0, 127, &FETCH_RESP_TOPIC}))

// -- Metadata (v0-v5)
SCHEMA(METADATA_REQ_TOPIC,
  FLD({"name", T_STRING, 0, 127, nullptr}))
SCHEMA(METADATA_REQ,
  FLD({"topics", T_NARRAY, 0, 127, &METADATA_REQ_TOPIC}),
  FLD({"allow_auto_topic_creation", T_BOOL, 4, 127, nullptr}))
SCHEMA(MD_BROKER,
  FLD({"node_id", T_INT32, 0, 127, nullptr}),
  FLD({"host", T_STRING, 0, 127, nullptr}),
  FLD({"port", T_INT32, 0, 127, nullptr}),
  FLD({"rack", T_NSTRING, 1, 127, nullptr}))
SCHEMA(MD_PART,
  FLD({"error_code", T_INT16, 0, 127, nullptr}),
  FLD({"partition_index", T_INT32, 0, 127, nullptr}),
  FLD({"leader_id", T_INT32, 0, 127, nullptr}),
  FLD({"replica_nodes", T_INT32S, 0, 127, nullptr}),
  FLD({"isr_nodes", T_INT32S, 0, 127, nullptr}),
  FLD({"offline_replicas", T_INT32S, 5, 127, nullptr}))
SCHEMA(MD_TOPIC,
  FLD({"error_code", T_INT16, 0, 127, nullptr}),
  FLD({"name", T_STRING, 0, 127, nullptr}),
  FLD({"is_internal", T_BOOL, 1, 127, nullptr}),
  FLD({"partitions", T_ARRAY, 0, 127, &MD_PART}))
SCHEMA(METADATA_RESP,
  FLD({"throttle_time_ms", T_INT32, 3, 127, nullptr}),
  FLD({"brokers", T_ARRAY, 0, 127, &MD_BROKER}),
  FLD({"cluster_id", T_NSTRING, 2, 127, nullptr}),
  FLD({"controller_id", T_INT32, 1, 127, nullptr}),
  FLD({"topics", T_ARRAY, 0, 127, &MD_TOPIC}))

// -- LeaderAndIsr (v0)
SCHEMA(LAI_PART,
  FLD({"topic", T_STRING, 0, 127, nullptr}),
  FLD({"partition", T_INT32, 0, 127, nullptr}),
  FLD({"controller_epoch", T_INT32, 0, 127, nullptr}),
  FLD({"leader", T_INT32, 0, 127, nullptr}),
  FLD({"leader_epoch", T_INT32, 0, 127, nullptr}),
  FLD({"isr", T_INT32S, 0, 127, nullptr}),
  FLD({"zk_version", T_INT32, 0, 127, nullptr}),
  FLD({"replicas", T_INT32S, 0, 127, nullptr}))
SCHEMA(LAI_LEADER,
  FLD({"broker_id", T_INT32, 0, 127, nullptr}),
  FLD({"host", T_STRING, 0, 127, nullptr}),
  FLD({"port", T_INT32, 0, 127, nullptr}))
SCHEMA(LAI_REQ,
  FLD({"controller_id", T_INT32, 0, 127, nullptr}),
  FLD({"controller_epoch", T_INT32, 0, 127, nullptr}),
  FLD({"partition_states", T_ARRAY, 0, 127, &LAI_PART}),
  FLD({"live_leaders", T_ARRAY, 0, 127, &LAI_LEADER}))
SCHEMA(LAI_PERR,
  FLD({"topic", T_STRING, 0, 127, nullptr}),
  FLD({"partition", T_INT32, 0, 127, nullptr}),
  FLD({"error_code", T_INT16, 0, 127, nullptr}))
SCHEMA(LAI_RESP,
  FLD({"error_code", T_INT16, 0, 127, nullptr}),
  FLD({"partition_errors", T_ARRAY, 0, 127, &LAI_PERR}))

// -- FindCoordinator (v0-v2)
SCHEMA(FIND_COORD_REQ,
  FLD({"key", T_STRING, 0, 127, nullptr}),
  FLD({"key_type", T_INT8, 1, 127, nullptr}))
SCHEMA(FIND_COORD_RESP,
  FLD({"throttle_time_ms", T_INT32, 1, 127, nullptr}),
  FLD({"error_code", T_INT16, 0, 127, nullptr}),
  FLD({"error_message", T_NSTRING, 1, 127, nullptr}),
  FLD({"node_id", T_INT32, 0, 127, nullptr}),
  FLD({"host", T_STRING, 0, 127, nullptr}),
  FLD({"port", T_INT32, 0, 127, nullptr}))

// -- ListGroups (v0-v2)
const Schema LIST_GROUPS_REQ = {nullptr, 0};
SCHEMA(LG_GROUP,
  FLD({"group_id", T_STRING, 0, 127, nullptr}),
  FLD({"protocol_type", T_STRING, 0, 127, nullptr}))
SCHEMA(LIST_GROUPS_RESP,
  FLD({"throttle_time_ms", T_INT32, 1, 127, nullptr}),
  FLD({"error_code", T_INT16, 0, 127, nullptr}),
  FLD({"groups", T_ARRAY, 0, 127, &LG_GROUP}))

// -- ApiVersions (v0-v3; v3 flexible)
SCHEMA(API_VERSIONS_REQ,
  FLD({"client_software_name", T_STRING, 3, 127, nullptr}),
  FLD({"client_software_version", T_STRING, 3, 127, nullptr}))
SCHEMA(AV_KEY,
  FLD({"api_key", T_INT16, 0, 127, nullptr}),
  FLD({"min_version", T_INT16, 0, 127, nullptr}),
  FLD({"max_version", T_INT16, 0, 127, nullptr}))
SCHEMA(API_VERSIONS_RESP,
  FLD({"error_code", T_INT16, 0, 127, nullptr}),
  FLD({"api_keys", T_ARRAY, 0, 127, &AV_KEY}),
  FLD({"throttle_time_ms", T_INT32, 1, 127, nullptr}))

// -- CreateTopics (v0-v2)
SCHEMA(CT_ASSIGN,
  FLD({"partition_index", T_INT32, 0, 127, nullptr}),
  FLD({"broker_ids", T_INT32S, 0, 127, nullptr}))
SCHEMA(CT_CONFIG,
  FLD({"name", T_STRING, 0, 127, nullptr}),
  FLD({"value", T_NSTRING, 0, 127, nullptr}))
SCHEMA(CT_TOPIC,
  FLD({"name", T_STRING, 0, 127, nullptr}),
  FLD({"num_partitions", T_INT32, 0, 127, nullptr}),
  FLD({"replication_factor", T_INT16, 0, 127, nullptr}),
  FLD({"assignments", T_ARRAY, 0, 127, &CT_ASSIGN}),
  FLD({"configs", T_ARRAY, 0, 127, &CT_CONFIG}))
SCHEMA(CREATE_TOPICS_REQ,
  FLD({"topics", T_ARRAY, 0, 127, &CT_TOPIC}),
  FLD({"timeout_ms", T_INT32, 0, 127, nullptr}),
  FLD({"validate_only", T_BOOL, 1, 127, nullptr}))
SCHEMA(CT_RTOPIC,
  FLD({"name", T_STRING, 0, 127, nullptr}),
  FLD({"error_code", T_INT16, 0, 127, nullptr}),
  FLD({"error_message", T_NSTRING, 1, 127, nullptr}))
SCHEMA(CREATE_TOPICS_RESP,
  FLD({"throttle_time_ms", T_INT32, 2, 127, nullptr}),
  FLD({"topics", T_ARRAY, 0, 127, &CT_RTOPIC}))

// -- ListOffsets (v1-v2; v1 switched to single-offset responses)
SCHEMA(LO_REQ_PART,
  FLD({"partition_index", T_INT32, 0, 127, nullptr}),
  FLD({"timestamp", T_INT64, 0, 127, nullptr}))
SCHEMA(LO_REQ_TOPIC,
  FLD({"name", T_STRING, 0, 127, nullptr}),
  FLD({"partitions", T_ARRAY, 0, 127, &LO_REQ_PART}))
SCHEMA(LIST_OFFSETS_REQ,
  FLD({"replica_id", T_INT32, 0, 127, nullptr}),
  FLD({"isolation_level", T_INT8, 2, 127, nullptr}),
  FLD({"topics", T_ARRAY, 0, 127, &LO_REQ_TOPIC}))
SCHEMA(LO_RESP_PART,
  FLD({"partition_index", T_INT32, 0, 127, nullptr}),
  FLD({"error_code", T_INT16, 0, 127, nullptr}),
  FLD({"timestamp", T_INT64, 1, 127, nullptr}),
  FLD({"offset", T_INT64, 1, 127, nullptr}))
SCHEMA(LO_RESP_TOPIC,
  FLD({"name", T_STRING, 0, 127, nullptr}),
  FLD({"partitions", T_ARRAY, 0, 127, &LO_RESP_PART}))
SCHEMA(LIST_OFFSETS_RESP,
  FLD({"throttle_time_ms", T_INT32, 2, 127, nullptr}),
  FLD({"topics", T_ARRAY, 0, 127, &LO_RESP_TOPIC}))

// -- InitProducerId (v0-v1; idempotent-producer id allocation — no
// transactional support: transactional_id must be null)
SCHEMA(INIT_PRODUCER_ID_REQ,
  FLD({"transactional_id", T_NSTRING, 0, 127, nullptr}),
  FLD({"transaction_timeout_ms", T_INT32, 0, 127, nullptr}))
SCHEMA(INIT_PRODUCER_ID_RESP,
  FLD({"throttle_time_ms", T_INT32, 0, 127, nullptr}),
  FLD({"error_code", T_INT16, 0, 127, nullptr}),
  FLD({"producer_id", T_INT64, 0, 127, nullptr}),
  FLD({"producer_epoch", T_INT16, 0, 127, nullptr}))

// -- OffsetCommit (v2-v3)
SCHEMA(OC_REQ_PART,
  FLD({"partition_index", T_INT32, 0, 127, nullptr}),
  FLD({"committed_offset", T_INT64, 0, 127, nullptr}),
  FLD({"committed_metadata", T_NSTRING, 0, 127, nullptr}))
SCHEMA(OC_REQ_TOPIC,
  FLD({"name", T_STRING, 0, 127, nullptr}),
  FLD({"partitions", T_ARRAY, 0, 127, &OC_REQ_PART}))
SCHEMA(OFFSET_COMMIT_REQ,
  FLD({"group_id", T_STRING, 0, 127, nullptr}),
  FLD({"generation_id", T_INT32, 1, 127, nullptr}),
  FLD({"member_id", T_STRING, 1, 127, nullptr}),
  FLD({"retention_time_ms", T_INT64, 2, 4, nullptr}),
  FLD({"topics", T_ARRAY, 0, 127, &OC_REQ_TOPIC}))
SCHEMA(OC_RESP_PART,
  FLD({"partition_index", T_INT32, 0, 127, nullptr}),
  FLD({"error_code", T_INT16, 0, 127, nullptr}))
SCHEMA(OC_RESP_TOPIC,
  FLD({"name", T_STRING, 0, 127, nullptr}),
  FLD({"partitions", T_ARRAY, 0, 127, &OC_RESP_PART}))
SCHEMA(OFFSET_COMMIT_RESP,
  FLD({"throttle_time_ms", T_INT32, 3, 127, nullptr}),
  FLD({"topics", T_ARRAY, 0, 127, &OC_RESP_TOPIC}))

// -- OffsetFetch (v1-v3; topics nullable from v2 = "all topics")
SCHEMA(OF_REQ_TOPIC,
  FLD({"name", T_STRING, 0, 127, nullptr}),
  FLD({"partition_indexes", T_INT32S, 0, 127, nullptr}))
SCHEMA(OFFSET_FETCH_REQ,
  FLD({"group_id", T_STRING, 0, 127, nullptr}),
  FLD({"topics", T_NARRAY, 0, 127, &OF_REQ_TOPIC}))
SCHEMA(OF_RESP_PART,
  FLD({"partition_index", T_INT32, 0, 127, nullptr}),
  FLD({"committed_offset", T_INT64, 0, 127, nullptr}),
  FLD({"metadata", T_NSTRING, 0, 127, nullptr}),
  FLD({"error_code", T_INT16, 0, 127, nullptr}))
SCHEMA(OF_RESP_TOPIC,
  FLD({"name", T_STRING, 0, 127, nullptr}),
  FLD({"partitions", T_ARRAY, 0, 127, &OF_RESP_PART}))
SCHEMA(OFFSET_FETCH_RESP,
  FLD({"throttle_time_ms", T_INT32, 3, 127, nullptr}),
  FLD({"topics", T_ARRAY, 0, 127, &OF_RESP_TOPIC}),
  FLD({"error_code", T_INT16, 2, 127, nullptr}))

// -- JoinGroup (v0-v2)
SCHEMA(JG_PROTOCOL,
  FLD({"name", T_STRING, 0, 127, nullptr}),
  FLD({"metadata", T_BYTES, 0, 127, nullptr}))
SCHEMA(JOIN_GROUP_REQ,
  FLD({"group_id", T_STRING, 0, 127, nullptr}),
  FLD({"session_timeout_ms", T_INT32, 0, 127, nullptr}),
  FLD({"rebalance_timeout_ms", T_INT32, 1, 127, nullptr}),
  FLD({"member_id", T_STRING, 0, 127, nullptr}),
  FLD({"protocol_type", T_STRING, 0, 127, nullptr}),
  FLD({"protocols", T_ARRAY, 0, 127, &JG_PROTOCOL}))
SCHEMA(JG_MEMBER,
  FLD({"member_id", T_STRING, 0, 127, nullptr}),
  FLD({"metadata", T_BYTES, 0, 127, nullptr}))
SCHEMA(JOIN_GROUP_RESP,
  FLD({"throttle_time_ms", T_INT32, 2, 127, nullptr}),
  FLD({"error_code", T_INT16, 0, 127, nullptr}),
  FLD({"generation_id", T_INT32, 0, 127, nullptr}),
  FLD({"protocol_name", T_STRING, 0, 127, nullptr}),
  FLD({"leader", T_STRING, 0, 127, nullptr}),
  FLD({"member_id", T_STRING, 0, 127, nullptr}),
  FLD({"members", T_ARRAY, 0, 127, &JG_MEMBER}))

// -- Heartbeat (v0-v1)
SCHEMA(HEARTBEAT_REQ,
  FLD({"group_id", T_STRING, 0, 127, nullptr}),
  FLD({"generation_id", T_INT32, 0, 127, nullptr}),
  FLD({"member_id", T_STRING, 0, 127, nullptr}))
SCHEMA(HEARTBEAT_RESP,
  FLD({"throttle_time_ms", T_INT32, 1, 127, nullptr}),
  FLD({"error_code", T_INT16, 0, 127, nullptr}))

// -- LeaveGroup (v0-v1)
SCHEMA(LEAVE_GROUP_REQ,
  FLD({"group_id", T_STRING, 0, 127, nullptr}),
  FLD({"member_id", T_STRING, 0, 127, nullptr}))
SCHEMA(LEAVE_GROUP_RESP,
  FLD({"throttle_time_ms", T_INT32, 1, 127, nullptr}),
  FLD({"error_code", T_INT16, 0, 127, nullptr}))

// -- SyncGroup (v0-v1)
SCHEMA(SG_ASSIGNMENT,
  FLD({"member_id", T_STRING, 0, 127, nullptr}),
  FLD({"assignment", T_BYTES, 0, 127, nullptr}))
SCHEMA(SYNC_GROUP_REQ,
  FLD({"group_id", T_STRING, 0, 127, nullptr}),
  FLD({"generation_id", T_INT32, 0, 127, nullptr}),
  FLD({"member_id", T_STRING, 0, 127, nullptr}),
  FLD({"assignments", T_ARRAY, 0, 127, &SG_ASSIGNMENT}))
SCHEMA(SYNC_GROUP_RESP,
  FLD({"throttle_time_ms", T_INT32, 1, 127, nullptr}),
  FLD({"error_code", T_INT16, 0, 127, nullptr}),
  FLD({"assignment", T_BYTES, 0, 127, nullptr}))

// -- DescribeGroups (v0-v1)
SCHEMA(DESCRIBE_GROUPS_REQ,
  FLD({"groups", T_STRINGS, 0, 127, nullptr}))
SCHEMA(DG_MEMBER,
  FLD({"member_id", T_STRING, 0, 127, nullptr}),
  FLD({"client_id", T_STRING, 0, 127, nullptr}),
  FLD({"client_host", T_STRING, 0, 127, nullptr}),
  FLD({"member_metadata", T_BYTES, 0, 127, nullptr}),
  FLD({"member_assignment", T_BYTES, 0, 127, nullptr}))
SCHEMA(DG_GROUP,
  FLD({"error_code", T_INT16, 0, 127, nullptr}),
  FLD({"group_id", T_STRING, 0, 127, nullptr}),
  FLD({"group_state", T_STRING, 0, 127, nullptr}),
  FLD({"protocol_type", T_STRING, 0, 127, nullptr}),
  FLD({"protocol_data", T_STRING, 0, 127, nullptr}),
  FLD({"members", T_ARRAY, 0, 127, &DG_MEMBER}))
SCHEMA(DESCRIBE_GROUPS_RESP,
  FLD({"throttle_time_ms", T_INT32, 1, 127, nullptr}),
  FLD({"groups", T_ARRAY, 0, 127, &DG_GROUP}))

// -- DeleteTopics (v0-v1)
SCHEMA(DELETE_TOPICS_REQ,
  FLD({"topic_names", T_STRINGS, 0, 127, nullptr}),
  FLD({"timeout_ms", T_INT32, 0, 127, nullptr}))
SCHEMA(DT_RESP,
  FLD({"name", T_STRING, 0, 127, nullptr}),
  FLD({"error_code", T_INT16, 0, 127, nullptr}))
SCHEMA(DELETE_TOPICS_RESP,
  FLD({"throttle_time_ms", T_INT32, 1, 127, nullptr}),
  FLD({"responses", T_ARRAY, 0, 127, &DT_RESP}))

struct ApiSchemas {
  int16_t key;
  const Schema* req;
  const Schema* resp;
};
const ApiSchemas API_SCHEMAS[] = {
    {API_PRODUCE, &PRODUCE_REQ, &PRODUCE_RESP},
    {API_FETCH, &FETCH_REQ, &FETCH_RESP},
    {API_LIST_OFFSETS, &LIST_OFFSETS_REQ, &LIST_OFFSETS_RESP},
    {API_METADATA, &METADATA_REQ, &METADATA_RESP},
    {API_LEADER_AND_ISR, &LAI_REQ, &LAI_RESP},
    {API_OFFSET_COMMIT, &OFFSET_COMMIT_REQ, &OFFSET_COMMIT_RESP},
    {API_OFFSET_FETCH, &OFFSET_FETCH_REQ, &OFFSET_FETCH_RESP},
    {API_FIND_COORDINATOR, &FIND_COORD_REQ, &FIND_COORD_RESP},
    {API_JOIN_GROUP, &JOIN_GROUP_REQ, &JOIN_GROUP_RESP},
    {API_HEARTBEAT, &HEARTBEAT_REQ, &HEARTBEAT_RESP},
    {API_LEAVE_GROUP, &LEAVE_GROUP_REQ, &LEAVE_GROUP_RESP},
    {API_SYNC_GROUP, &SYNC_GROUP_REQ, &SYNC_GROUP_RESP},
    {API_DESCRIBE_GROUPS, &DESCRIBE_GROUPS_REQ, &DESCRIBE_GROUPS_RESP},
    {API_LIST_GROUPS, &LIST_GROUPS_REQ, &LIST_GROUPS_RESP},
    {API_API_VERSIONS, &API_VERSIONS_REQ, &API_VERSIONS_RESP},
    {API_CREATE_TOPICS, &CREATE_TOPICS_REQ, &CREATE_TOPICS_RESP},
    {API_DELETE_TOPICS, &DELETE_TOPICS_REQ, &DELETE_TOPICS_RESP},
    {API_INIT_PRODUCER_ID, &INIT_PRODUCER_ID_REQ, &INIT_PRODUCER_ID_RESP},
};

const Schema* find_schema(int16_t key, bool response) {
  for (const auto& s : API_SCHEMAS)
    if (s.key == key) return response ? s.resp : s.req;
  return nullptr;
}

// -------------------------------------------------- generic decode walker
PyObject* decode_struct(Reader& r, const Schema& sc, int ver, bool flexible);

PyObject* decode_string(Reader& r, bool nullable, bool flexible) {
  int32_t len;
  if (flexible) {
    uint32_t u = r.uvarint();
    len = (int32_t)u - 1;
  } else {
    len = r.i16();
  }
  if (len < 0) {
    if (!nullable) { r.ok = false; r.err = "null non-nullable string"; return nullptr; }
    Py_RETURN_NONE;
  }
  const uint8_t* d = r.raw(len);
  if (!d) return nullptr;
  return PyUnicode_DecodeUTF8((const char*)d, len, "replace");
}

PyObject* decode_bytes(Reader& r, bool nullable, bool flexible) {
  int64_t len;
  if (flexible) {
    len = (int64_t)r.uvarint() - 1;
  } else {
    len = r.i32();
  }
  if (len < 0) {
    if (!nullable) { r.ok = false; r.err = "null non-nullable bytes"; return nullptr; }
    Py_RETURN_NONE;
  }
  const uint8_t* d = r.raw(len);
  if (!d) return nullptr;
  return PyBytes_FromStringAndSize((const char*)d, len);
}

int64_t decode_array_len(Reader& r, bool nullable, bool flexible) {
  int64_t cnt = flexible ? (int64_t)r.uvarint() - 1 : r.i32();
  if (cnt < 0 && !nullable) { r.ok = false; r.err = "null non-nullable array"; }
  if (cnt > (int64_t)r.n) { r.ok = false; r.err = "array length exceeds buffer"; }
  return cnt;
}

PyObject* decode_field(Reader& r, const Field& f, int ver, bool flexible) {
  switch (f.type) {
    case T_BOOL: return PyBool_FromLong(r.u8() != 0);
    case T_INT8: return PyLong_FromLong(r.i8());
    case T_INT16: return PyLong_FromLong(r.i16());
    case T_INT32: return PyLong_FromLong(r.i32());
    case T_INT64: return PyLong_FromLongLong(r.i64());
    case T_STRING: return decode_string(r, false, flexible);
    case T_NSTRING: return decode_string(r, true, flexible);
    case T_BYTES: return decode_bytes(r, false, flexible);
    case T_NBYTES: return decode_bytes(r, true, flexible);
    case T_INT32S: {
      int64_t cnt = decode_array_len(r, false, flexible);
      if (!r.ok) return nullptr;
      PyObject* lst = PyList_New(0);
      if (!lst) return nullptr;
      for (int64_t i = 0; i < cnt && r.ok; i++) {
        PyObject* v = PyLong_FromLong(r.i32());
        if (!v || PyList_Append(lst, v) < 0) { Py_XDECREF(v); Py_DECREF(lst); return nullptr; }
        Py_DECREF(v);
      }
      return lst;
    }
    case T_STRINGS: {
      int64_t cnt = decode_array_len(r, false, flexible);
      if (!r.ok) return nullptr;
      PyObject* lst = PyList_New(0);
      if (!lst) return nullptr;
      for (int64_t i = 0; i < cnt && r.ok; i++) {
        PyObject* v = decode_string(r, false, flexible);
        if (!v || PyList_Append(lst, v) < 0) { Py_XDECREF(v); Py_DECREF(lst); return nullptr; }
        Py_DECREF(v);
      }
      if (!r.ok) { Py_DECREF(lst); return nullptr; }
      return lst;
    }
    case T_ARRAY:
    case T_NARRAY: {
      int64_t cnt = decode_array_len(r, f.type == T_NARRAY, flexible);
      if (!r.ok) return nullptr;
      if (cnt < 0) Py_RETURN_NONE;
      PyObject* lst = PyList_New(0);
      if (!lst) return nullptr;
      for (int64_t i = 0; i < cnt && r.ok; i++) {
        PyObject* el = decode_struct(r, *f.sub, ver, flexible);
        if (!el || PyList_Append(lst, el) < 0) { Py_XDECREF(el); Py_DECREF(lst); return nullptr; }
        Py_DECREF(el);
      }
      return lst;
    }
  }
  r.ok = false;
  r.err = "unknown field type";
  return nullptr;
}

PyObject* decode_struct(Reader& r, const Schema& sc, int ver, bool flexible) {
  PyObject* d = PyDict_New();
  if (!d) return nullptr;
  for (int i = 0; i < sc.nfields && r.ok; i++) {
    const Field& f = sc.fields[i];
    if (ver < f.min_ver || ver > f.max_ver) continue;
    PyObject* v = decode_field(r, f, ver, flexible);
    if (!v) { Py_DECREF(d); return nullptr; }
    if (PyDict_SetItemString(d, f.name, v) < 0) { Py_DECREF(v); Py_DECREF(d); return nullptr; }
    Py_DECREF(v);
  }
  if (flexible) r.skip_tagged();
  if (!r.ok) { Py_DECREF(d); return nullptr; }
  return d;
}

// -------------------------------------------------- generic encode walker
bool encode_struct(Writer& w, const Schema& sc, int ver, bool flexible, PyObject* obj);

bool enc_err(const char* field, const char* what) {
  PyErr_Format(PyExc_ValueError, "field %s: %s", field, what);
  return false;
}

bool encode_field(Writer& w, const Field& f, int ver, bool flexible, PyObject* v) {
  switch (f.type) {
    case T_BOOL:
      w.u8(v && PyObject_IsTrue(v) ? 1 : 0);
      return true;
    case T_INT8:
    case T_INT16:
    case T_INT32:
    case T_INT64: {
      long long x = 0;
      if (v && v != Py_None) {
        x = PyLong_AsLongLong(v);
        if (x == -1 && PyErr_Occurred()) return enc_err(f.name, "not an int");
      }
      if (f.type == T_INT8) w.u8((uint8_t)x);
      else if (f.type == T_INT16) w.i16((int16_t)x);
      else if (f.type == T_INT32) w.i32((int32_t)x);
      else w.i64(x);
      return true;
    }
    case T_STRING:
    case T_NSTRING: {
      if (!v || v == Py_None) {
        if (f.type == T_NSTRING) {
          if (flexible) w.uvarint(0); else w.i16(-1);
          return true;
        }
        if (flexible) w.uvarint(1); else w.i16(0);  // "" default
        return true;
      }
      Py_ssize_t len;
      const char* s = PyUnicode_AsUTF8AndSize(v, &len);
      if (!s) return enc_err(f.name, "not a str");
      if (len > 0x7FFF && !flexible) return enc_err(f.name, "string too long");
      if (flexible) w.uvarint((uint32_t)len + 1); else w.i16((int16_t)len);
      w.raw(s, len);
      return true;
    }
    case T_BYTES:
    case T_NBYTES: {
      if (!v || v == Py_None) {
        if (f.type == T_NBYTES) {
          if (flexible) w.uvarint(0); else w.i32(-1);
          return true;
        }
        if (flexible) w.uvarint(1); else w.i32(0);
        return true;
      }
      Py_buffer b;
      if (PyObject_GetBuffer(v, &b, PyBUF_SIMPLE) < 0)
        return enc_err(f.name, "not bytes-like");
      if (flexible) w.uvarint((uint32_t)b.len + 1); else w.i32((int32_t)b.len);
      w.raw(b.buf, b.len);
      PyBuffer_Release(&b);
      return true;
    }
    case T_INT32S: {
      if (!v || v == Py_None) {
        if (flexible) w.uvarint(1); else w.i32(0);
        return true;
      }
      PyObject* seq = PySequence_Fast(v, "expected a sequence");
      if (!seq) return enc_err(f.name, "not a sequence");
      Py_ssize_t cnt = PySequence_Fast_GET_SIZE(seq);
      if (flexible) w.uvarint((uint32_t)cnt + 1); else w.i32((int32_t)cnt);
      for (Py_ssize_t i = 0; i < cnt; i++) {
        long long x = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(seq, i));
        if (x == -1 && PyErr_Occurred()) { Py_DECREF(seq); return enc_err(f.name, "element not an int"); }
        w.i32((int32_t)x);
      }
      Py_DECREF(seq);
      return true;
    }
    case T_STRINGS: {
      if (!v || v == Py_None) {
        if (flexible) w.uvarint(1); else w.i32(0);
        return true;
      }
      PyObject* seq = PySequence_Fast(v, "expected a sequence");
      if (!seq) return enc_err(f.name, "not a sequence");
      Py_ssize_t cnt = PySequence_Fast_GET_SIZE(seq);
      if (flexible) w.uvarint((uint32_t)cnt + 1); else w.i32((int32_t)cnt);
      for (Py_ssize_t i = 0; i < cnt; i++) {
        PyObject* el = PySequence_Fast_GET_ITEM(seq, i);
        Py_ssize_t len;
        const char* s = PyUnicode_AsUTF8AndSize(el, &len);
        if (!s) { Py_DECREF(seq); return enc_err(f.name, "element not a str"); }
        if (len > 0x7FFF && !flexible) { Py_DECREF(seq); return enc_err(f.name, "string too long"); }
        if (flexible) w.uvarint((uint32_t)len + 1); else w.i16((int16_t)len);
        w.raw(s, len);
      }
      Py_DECREF(seq);
      return true;
    }
    case T_ARRAY:
    case T_NARRAY: {
      if (!v || v == Py_None) {
        if (f.type == T_NARRAY) {
          if (flexible) w.uvarint(0); else w.i32(-1);
        } else {
          if (flexible) w.uvarint(1); else w.i32(0);
        }
        return true;
      }
      PyObject* seq = PySequence_Fast(v, "expected a sequence");
      if (!seq) return enc_err(f.name, "not a sequence");
      Py_ssize_t cnt = PySequence_Fast_GET_SIZE(seq);
      if (flexible) w.uvarint((uint32_t)cnt + 1); else w.i32((int32_t)cnt);
      for (Py_ssize_t i = 0; i < cnt; i++) {
        if (!encode_struct(w, *f.sub, ver, flexible, PySequence_Fast_GET_ITEM(seq, i))) {
          Py_DECREF(seq);
          return false;
        }
      }
      Py_DECREF(seq);
      return true;
    }
  }
  return enc_err(f.name, "unknown field type");
}

bool encode_struct(Writer& w, const Schema& sc, int ver, bool flexible, PyObject* obj) {
  if (!PyDict_Check(obj)) {
    PyErr_SetString(PyExc_TypeError, "schema struct must be a dict");
    return false;
  }
  for (int i = 0; i < sc.nfields; i++) {
    const Field& f = sc.fields[i];
    if (ver < f.min_ver || ver > f.max_ver) continue;
    PyObject* v = PyDict_GetItemString(obj, f.name);  // borrowed, may be null
    if (!encode_field(w, f, ver, flexible, v)) return false;
  }
  if (flexible) w.tagged();
  return true;
}

// ------------------------------------------------------------ module fns
bool check_version(const ApiRange* r, int ver) {
  if (!r) {
    PyErr_SetString(PyExc_ValueError, "unsupported api_key");
    return false;
  }
  if (ver < r->min_ver || ver > r->max_ver) {
    PyErr_Format(PyExc_ValueError, "api %d version %d outside supported [%d, %d]",
                 r->key, ver, r->min_ver, r->max_ver);
    return false;
  }
  return true;
}

// decode_request(payload) -> dict
PyObject* py_decode_request(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  Reader r((const uint8_t*)buf.buf, buf.len);
  int16_t api_key = r.i16();
  int16_t api_ver = r.i16();
  int32_t corr = r.i32();
  const ApiRange* range = find_api(api_key);
  if (!r.ok || !range || api_ver < range->min_ver || api_ver > range->max_ver) {
    // Recoverable: the server answers UNSUPPORTED_VERSION using these.
    PyBuffer_Release(&buf);
    if (!r.ok) {
      PyErr_SetString(PyExc_ValueError, "truncated request header");
      return nullptr;
    }
    return Py_BuildValue("{s:h,s:h,s:i,s:O,s:O}", "api_key", api_key,
                         "api_version", api_ver, "correlation_id", corr,
                         "client_id", Py_None, "body", Py_None);
  }
  bool flexible = api_ver >= range->flexible_from;
  // client_id: legacy nullable string even in flexible headers (KIP-482).
  PyObject* client_id = decode_string(r, true, false);
  if (flexible) r.skip_tagged();
  PyObject* body = nullptr;
  if (client_id && r.ok)
    body = decode_struct(r, *find_schema(api_key, false), api_ver, flexible);
  PyBuffer_Release(&buf);
  if (!client_id || !body) {
    Py_XDECREF(client_id);
    Py_XDECREF(body);
    if (!PyErr_Occurred())
      PyErr_Format(PyExc_ValueError, "malformed request: %s", r.err.c_str());
    return nullptr;
  }
  PyObject* out = Py_BuildValue("{s:h,s:h,s:i,s:N,s:N}", "api_key", api_key,
                                "api_version", api_ver, "correlation_id", corr,
                                "client_id", client_id, "body", body);
  return out;
}

// encode_response(api_key, api_version, correlation_id, body) -> bytes
PyObject* py_encode_response(PyObject*, PyObject* args) {
  int api_key, api_ver, corr;
  PyObject* body;
  if (!PyArg_ParseTuple(args, "iiiO!", &api_key, &api_ver, &corr, &PyDict_Type, &body))
    return nullptr;
  const ApiRange* range = find_api((int16_t)api_key);
  if (!check_version(range, api_ver)) return nullptr;
  bool flexible = api_ver >= range->flexible_from;
  Writer w;
  w.i32(corr);
  // ApiVersions responses always use header v0 (clients must parse them
  // before knowing the negotiated version).
  if (flexible && api_key != API_API_VERSIONS) w.tagged();
  if (!encode_struct(w, *find_schema(api_key, true), api_ver, flexible, body))
    return nullptr;
  return PyBytes_FromStringAndSize((const char*)w.buf.data(), w.buf.size());
}

// encode_request(api_key, api_version, correlation_id, client_id, body) -> bytes
PyObject* py_encode_request(PyObject*, PyObject* args) {
  int api_key, api_ver, corr;
  PyObject* client_id;
  PyObject* body;
  if (!PyArg_ParseTuple(args, "iiiOO!", &api_key, &api_ver, &corr, &client_id,
                        &PyDict_Type, &body))
    return nullptr;
  const ApiRange* range = find_api((int16_t)api_key);
  if (!check_version(range, api_ver)) return nullptr;
  bool flexible = api_ver >= range->flexible_from;
  Writer w;
  w.i16((int16_t)api_key);
  w.i16((int16_t)api_ver);
  w.i32(corr);
  if (client_id == Py_None) {
    w.i16(-1);
  } else {
    Py_ssize_t len;
    const char* s = PyUnicode_AsUTF8AndSize(client_id, &len);
    if (!s) return nullptr;
    if (len > 0x7FFF) {
      PyErr_SetString(PyExc_ValueError, "client_id too long");
      return nullptr;
    }
    w.i16((int16_t)len);
    w.raw(s, len);
  }
  if (flexible) w.tagged();
  if (!encode_struct(w, *find_schema(api_key, false), api_ver, flexible, body))
    return nullptr;
  return PyBytes_FromStringAndSize((const char*)w.buf.data(), w.buf.size());
}

// decode_response(api_key, api_version, payload) -> dict
PyObject* py_decode_response(PyObject*, PyObject* args) {
  int api_key, api_ver;
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "iiy*", &api_key, &api_ver, &buf)) return nullptr;
  const ApiRange* range = find_api((int16_t)api_key);
  if (!check_version(range, api_ver)) { PyBuffer_Release(&buf); return nullptr; }
  bool flexible = api_ver >= range->flexible_from;
  Reader r((const uint8_t*)buf.buf, buf.len);
  int32_t corr = r.i32();
  if (flexible && api_key != API_API_VERSIONS) r.skip_tagged();
  PyObject* body = decode_struct(r, *find_schema(api_key, true), api_ver, flexible);
  PyBuffer_Release(&buf);
  if (!body) {
    if (!PyErr_Occurred())
      PyErr_Format(PyExc_ValueError, "malformed response: %s", r.err.c_str());
    return nullptr;
  }
  return Py_BuildValue("{s:i,s:N}", "correlation_id", corr, "body", body);
}

PyObject* py_supported_apis(PyObject*, PyObject*) {
  PyObject* out = PyList_New(0);
  if (!out) return nullptr;
  for (const auto& r : API_RANGES) {
    PyObject* t = Py_BuildValue("(hhh)", r.key, r.min_ver, r.max_ver);
    if (!t || PyList_Append(out, t) < 0) { Py_XDECREF(t); Py_DECREF(out); return nullptr; }
    Py_DECREF(t);
  }
  return out;
}

PyMethodDef module_methods[] = {
    {"decode_request", py_decode_request, METH_VARARGS,
     "decode_request(payload) -> {api_key, api_version, correlation_id, "
     "client_id, body}; body is None for unsupported api/version"},
    {"encode_response", py_encode_response, METH_VARARGS,
     "encode_response(api_key, api_version, correlation_id, body) -> bytes"},
    {"encode_request", py_encode_request, METH_VARARGS,
     "encode_request(api_key, api_version, correlation_id, client_id, body) -> bytes"},
    {"decode_response", py_decode_response, METH_VARARGS,
     "decode_response(api_key, api_version, payload) -> {correlation_id, body}"},
    {"supported_apis", py_supported_apis, METH_NOARGS,
     "[(api_key, min_version, max_version)]"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kafka_codec_module = {
    PyModuleDef_HEAD_INIT, "_kafka_codec",
    "Kafka wire protocol codec (schema-table driven, flexible-version aware)",
    -1, module_methods,
};

}  // namespace

extern "C" __attribute__((visibility("default"))) PyObject* PyInit__kafka_codec() {
  return PyModule_Create(&kafka_codec_module);
}
