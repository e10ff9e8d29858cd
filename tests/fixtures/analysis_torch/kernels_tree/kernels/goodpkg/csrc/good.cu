// Fixture: an entry tested against its ref (good_launch), one reached by
// a test that compares with no ref (spare_launch, KP004), and a
// declaration, which is no definition (other_launch).
extern "C" int other_launch(const void* x, int n, void* stream);

extern "C" int good_launch(const void* x, void* out, int n,
                           void* stream) {
  return 0;
}

extern "C" int spare_launch(const void* x, void* out, int n, void* stream) {
  return 0;
}
