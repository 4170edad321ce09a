// ABI version of the port's host-helper library, the same number the
// reference's libretina_native.so reports for the same C interface
// (combine.cpp, flowdict.cpp and pack.cpp are copied from
// retina_tpu/native/ unchanged). The loader (native/__init__.py
// NATIVE_ABI_VERSION) refuses a library that reports another.
//   v2: rt_combine_stripe (striped multi-consumer combine) and
//       rt_flowwire_dense (v4 dense known-row bitstream)

#include <cstdint>

extern "C" {

uint32_t rt_abi_version(void) { return 2; }

}  // extern "C"
