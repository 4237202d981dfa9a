/* The part of libdeflate's API that native/bam_decoder.cpp calls, declared
 * for hosts that have the library (libdeflate.so.0) but not its header.
 * The declarations follow libdeflate's public header, whose ABI has been
 * stable since version 1.0. */
#ifndef L2T_LIBDEFLATE_DECL_H
#define L2T_LIBDEFLATE_DECL_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

struct libdeflate_decompressor;

enum libdeflate_result {
  LIBDEFLATE_SUCCESS = 0,
  LIBDEFLATE_BAD_DATA = 1,
  LIBDEFLATE_SHORT_OUTPUT = 2,
  LIBDEFLATE_INSUFFICIENT_SPACE = 3,
};

struct libdeflate_decompressor *libdeflate_alloc_decompressor(void);

enum libdeflate_result libdeflate_deflate_decompress(
    struct libdeflate_decompressor *decompressor, const void *in,
    size_t in_nbytes, void *out, size_t out_nbytes_avail,
    size_t *actual_out_nbytes_ret);

void libdeflate_free_decompressor(struct libdeflate_decompressor *decompressor);

#ifdef __cplusplus
}
#endif

#endif
