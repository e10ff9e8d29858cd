// Fixture: an entry no test reaches (KP004).
extern "C" int bad_launch(const void* x, void* out, int n, void* stream) {
  return 0;
}
