// The route report of the attention kernels, shared by every attention
// source: the launcher that made the last launch sets it to kind << 16 |
// dtype code << 12 | column tier (the column group's width on the
// column-group routes of head dims past 256); accl_attn_last_route
// (attention.cu) reads it. No launch reports ROUTE_DECODE_COLS_TF32 (19)
// any more: the f32 single-token decode past 2048 takes ROUTE_DECODE_BAND;
// the code keeps its number.
#pragma once

void set_attn_route(int kind, int dtype, int tier);
enum {
  ROUTE_FWD_WGMMA = 1, ROUTE_FWD_SINGLE_WGMMA = 2, ROUTE_PREFILL_WGMMA = 3,
  ROUTE_DECODE_SPLIT = 4, ROUTE_FWD_TF32 = 5, ROUTE_FWD_SINGLE_TF32 = 6,
  ROUTE_PREFILL_TF32 = 7, ROUTE_BWD_DKV_WGMMA = 8, ROUTE_BWD_DQ_WGMMA = 9,
  ROUTE_BWD_DKV_TF32 = 10, ROUTE_BWD_DQ_TF32 = 11,
  // the column-group form (D > 256); decode is S_new == 1 on the prefill
  // form's kernel
  ROUTE_FWD_COLS_WGMMA = 12, ROUTE_FWD_SINGLE_COLS_WGMMA = 13,
  ROUTE_PREFILL_COLS_WGMMA = 14, ROUTE_DECODE_COLS_WGMMA = 15,
  ROUTE_FWD_COLS_TF32 = 16, ROUTE_FWD_SINGLE_COLS_TF32 = 17,
  ROUTE_PREFILL_COLS_TF32 = 18, ROUTE_DECODE_COLS_TF32 = 19,
  ROUTE_BWD_DKV_COLS_WGMMA = 20, ROUTE_BWD_DQ_COLS_WGMMA = 21,
  ROUTE_BWD_DKV_COLS_TF32 = 22, ROUTE_BWD_DQ_COLS_TF32 = 23,
  // the 16-bit cluster forms, tier a block's slice: B10 (256 < D <= 1024,
  // 128 columns), B8, B9, the B12 chunks and B11 (256 < D <= 2048, 256)
  ROUTE_BWD_DKV_WGMMA_CLUSTER = 24, ROUTE_FWD_WGMMA_CLUSTER = 25,
  ROUTE_FWD_SINGLE_WGMMA_CLUSTER = 26, ROUTE_PREFILL_WGMMA_CLUSTER = 27,
  ROUTE_BWD_DQ_WGMMA_CLUSTER = 28,
  // the f32 band form of B10 and B11 (D > 4096), tier a product tile's
  // columns
  ROUTE_BWD_DKV_TF32_BAND = 29, ROUTE_BWD_DQ_TF32_BAND = 30,
  // the f32 band form of B8, B9 and the B12 chunks (D > 4096) and the f32
  // single-token decode past 2048 (attention_decode.cu), tier a product
  // tile's columns
  ROUTE_FWD_TF32_BAND = 31, ROUTE_FWD_SINGLE_TF32_BAND = 32,
  ROUTE_PREFILL_TF32_BAND = 33, ROUTE_DECODE_BAND = 34
};
