// Native Brainfuck executor: the sequential interpreter hot loop.
//
// Semantics are identical to the reference interpreter
// (crates/core/executor/src/executor.rs): clk += 2 per instruction, reads at
// clk+1, ALU writes at clk+2, per-address first/last access tracking for the
// memory-consistency argument.
//
// Emits columnar (struct-of-arrays) events so the Python side can wrap the
// buffers into numpy and feed trace generation on the device.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

struct MemCell {
  uint32_t value = 0;
  uint32_t ts = 0;
  // first/last tracking
  bool touched = false;
  uint32_t init_ts = 0;
  uint32_t init_value = 0;
};

struct Impl {
  std::vector<uint32_t> pc, next_pc, mp, next_mp, mv, next_mv, opcode, op_a;
  std::vector<uint32_t> mv_accessed, mv_prev_ts, mv_prev_value;
  std::vector<uint32_t> next_mv_accessed, next_mv_prev_ts;
  std::vector<uint32_t> m_addr, m_init_ts, m_init_val, m_final_ts, m_final_val;
  std::vector<uint8_t> output;
  uint64_t global_clk = 0;
  int status = 0;
};

// Tape: flat fast path for low addresses, hash map for the wrap-around tail.
struct Tape {
  static constexpr uint32_t kFlat = 1u << 22;
  std::vector<MemCell> flat;
  std::unordered_map<uint32_t, MemCell> high;
  std::vector<uint32_t> touched_order;

  MemCell& cell(uint32_t addr) {
    if (addr < kFlat) {
      if (flat.empty()) flat.resize(kFlat);
      return flat[addr];
    }
    return high[addr];
  }

  // returns (prev_value, prev_ts)
  inline std::pair<uint32_t, uint32_t> access(uint32_t addr, uint32_t ts,
                                              bool write, uint32_t new_value) {
    MemCell& c = cell(addr);
    uint32_t pv = c.value, pt = c.ts;
    if (!c.touched) {
      c.touched = true;
      c.init_ts = pt;
      c.init_value = pv;
      touched_order.push_back(addr);
    }
    if (write) c.value = new_value;
    c.ts = ts;
    return {pv, pt};
  }
};

}  // namespace

extern "C" {

struct BfRecord {
  uint64_t n_cycles;
  const uint32_t *pc, *next_pc, *mp, *next_mp, *mv, *next_mv, *opcode, *op_a;
  const uint32_t *mv_accessed, *mv_prev_ts, *mv_prev_value;
  const uint32_t *next_mv_accessed, *next_mv_prev_ts;
  uint64_t n_mem;
  const uint32_t *m_addr, *m_init_ts, *m_init_val, *m_final_ts, *m_final_val;
  uint64_t out_len;
  const uint8_t* output;
  uint64_t global_clk;
  int status;  // 0 ok, 1 input exhausted, 2 cycle limit exceeded
  Impl* impl;
};

BfRecord* bf_execute(const uint32_t* opcodes, const uint32_t* op_as,
                     uint64_t n_instr, const uint8_t* input,
                     uint64_t input_len, uint64_t max_cycles) {
  Impl* im = new Impl();
  Tape tape;

  uint64_t reserve = 1 << 12;
  auto reserve_all = [&](uint64_t n) {
    for (auto* v : {&im->pc, &im->next_pc, &im->mp, &im->next_mp, &im->mv,
                    &im->next_mv, &im->opcode, &im->op_a, &im->mv_accessed,
                    &im->mv_prev_ts, &im->mv_prev_value, &im->next_mv_accessed,
                    &im->next_mv_prev_ts})
      v->reserve(n);
  };
  reserve_all(reserve);

  uint32_t pc = 0, mem_ptr = 0, clk = 0;
  uint64_t inp = 0, cycles = 0;

  while (pc != (uint32_t)n_instr) {
    if (max_cycles && cycles >= max_cycles) {
      im->status = 2;
      break;
    }
    uint32_t op = opcodes[pc];
    uint32_t npc = pc + 1;
    uint32_t mv = 0, nmv = 0;
    uint32_t mp0 = mem_ptr;
    uint32_t mvacc = 0, mvpts = 0, mvpv = 0, nmvacc = 0, nmvpts = 0;

    switch (op) {
      case 2:    // +
      case 3: {  // -
        auto [pv, pt] = tape.access(mem_ptr, clk + 1, false, 0);
        mv = pv;
        mvpts = pt;
        mvpv = pv;
        mvacc = 1;
        nmv = (op == 2) ? ((mv + 1) & 0xFF) : ((mv + 255) & 0xFF);
        auto [pv2, pt2] = tape.access(mem_ptr, clk + 2, true, nmv);
        (void)pv2;
        nmvacc = 1;
        nmvpts = pt2;
        break;
      }
      case 0:    // [
      case 1: {  // ]
        auto [pv, pt] = tape.access(mem_ptr, clk + 1, false, 0);
        mv = pv;
        mvpts = pt;
        mvpv = pv;
        mvacc = 1;
        if ((op == 0 && mv == 0) || (op == 1 && mv != 0)) npc = op_as[pc];
        break;
      }
      case 4:
        mem_ptr += 1;
        break;
      case 5:
        mem_ptr -= 1;
        break;
      case 6: {  // ,
        if (inp >= input_len) {
          im->status = 1;
          goto done;
        }
        uint32_t byte = input[inp++];
        auto [pv, pt] = tape.access(mem_ptr, clk + 1, true, byte);
        mv = byte;
        mvpts = pt;
        mvpv = pv;
        mvacc = 1;
        break;
      }
      case 7: {  // .
        auto [pv, pt] = tape.access(mem_ptr, clk + 1, false, 0);
        mv = pv;
        mvpts = pt;
        mvpv = pv;
        mvacc = 1;
        im->output.push_back((uint8_t)mv);
        break;
      }
    }

    im->pc.push_back(pc);
    im->next_pc.push_back(npc);
    im->mp.push_back(mp0);
    im->next_mp.push_back(mem_ptr);
    im->mv.push_back(mv);
    im->next_mv.push_back(nmv);
    im->opcode.push_back(op);
    im->op_a.push_back(op_as[pc]);
    im->mv_accessed.push_back(mvacc);
    im->mv_prev_ts.push_back(mvpts);
    im->mv_prev_value.push_back(mvpv);
    im->next_mv_accessed.push_back(nmvacc);
    im->next_mv_prev_ts.push_back(nmvpts);

    pc = npc;
    clk += 2;
    cycles += 1;
  }
done:
  im->global_clk = cycles;

  // Sorted-by-address memory first/last table (deterministic order).
  std::vector<uint32_t> addrs = tape.touched_order;
  std::sort(addrs.begin(), addrs.end());
  for (uint32_t a : addrs) {
    MemCell& c = tape.cell(a);
    im->m_addr.push_back(a);
    im->m_init_ts.push_back(c.init_ts);
    im->m_init_val.push_back(c.init_value);
    im->m_final_ts.push_back(c.ts);
    im->m_final_val.push_back(c.value);
  }

  BfRecord* r = new BfRecord();
  r->impl = im;
  r->n_cycles = im->pc.size();
  r->pc = im->pc.data();
  r->next_pc = im->next_pc.data();
  r->mp = im->mp.data();
  r->next_mp = im->next_mp.data();
  r->mv = im->mv.data();
  r->next_mv = im->next_mv.data();
  r->opcode = im->opcode.data();
  r->op_a = im->op_a.data();
  r->mv_accessed = im->mv_accessed.data();
  r->mv_prev_ts = im->mv_prev_ts.data();
  r->mv_prev_value = im->mv_prev_value.data();
  r->next_mv_accessed = im->next_mv_accessed.data();
  r->next_mv_prev_ts = im->next_mv_prev_ts.data();
  r->n_mem = im->m_addr.size();
  r->m_addr = im->m_addr.data();
  r->m_init_ts = im->m_init_ts.data();
  r->m_init_val = im->m_init_val.data();
  r->m_final_ts = im->m_final_ts.data();
  r->m_final_val = im->m_final_val.data();
  r->out_len = im->output.size();
  r->output = im->output.data();
  r->global_clk = im->global_clk;
  r->status = im->status;
  return r;
}

void bf_free(BfRecord* r) {
  if (!r) return;
  delete r->impl;
  delete r;
}

}  // extern "C"
