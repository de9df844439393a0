// Fast DBoW2 text-vocabulary parser (C ABI, loaded via ctypes).
//
// Host-side native runtime component (a copy of weiner_slamit_v2_tpu/native/voc_loader.cpp) replacing the
// reference's DBoW2 loadFromTextFile
// (jni/Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1345-1440), which the
// reference notes "could take a while" on the ~1.08M-line ORBvoc.txt
// (jni/ORB_SLAM2/src/System.cc:124-129). A Python line parser takes minutes;
// this streaming C++ parser does the same file in seconds.
//
// File format: header "k L scoring weighting\n", then one node per line:
//   parent_id is_leaf d0 d1 ... d31 weight
//
// Build (native/__init__.py, at first use, into weiner_slamit_v2_torch/_build/):
//   g++ -O2 -shared -fPIC -o libwsnative.so voc_loader.cpp image_io.cpp -lz

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

struct VocData {
  int32_t k;
  int32_t L;
  int64_t n_nodes;
  int64_t* parents;   // n_nodes
  uint8_t* is_leaf;   // n_nodes
  uint8_t* descs;     // n_nodes * 32
  double* weights;    // n_nodes
};

// Parse the vocabulary file. Returns nullptr on failure.
VocData* voc_load_text(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;

  VocData* v = (VocData*)calloc(1, sizeof(VocData));
  if (fscanf(f, "%d %d", &v->k, &v->L) != 2) {
    fclose(f);
    free(v);
    return nullptr;
  }
  // skip scoring + weighting ints
  int scoring, weighting;
  if (fscanf(f, "%d %d", &scoring, &weighting) != 2) {
    fclose(f);
    free(v);
    return nullptr;
  }

  int64_t cap = 1 << 20;
  v->parents = (int64_t*)malloc(cap * sizeof(int64_t));
  v->is_leaf = (uint8_t*)malloc(cap);
  v->descs = (uint8_t*)malloc(cap * 32);
  v->weights = (double*)malloc(cap * sizeof(double));
  int64_t n = 0;

  for (;;) {
    long long parent;
    int leaf;
    if (fscanf(f, "%lld %d", &parent, &leaf) != 2) break;
    if (n == cap) {
      cap *= 2;
      v->parents = (int64_t*)realloc(v->parents, cap * sizeof(int64_t));
      v->is_leaf = (uint8_t*)realloc(v->is_leaf, cap);
      v->descs = (uint8_t*)realloc(v->descs, cap * 32);
      v->weights = (double*)realloc(v->weights, cap * sizeof(double));
    }
    v->parents[n] = parent;
    v->is_leaf[n] = (uint8_t)leaf;
    uint8_t* d = v->descs + n * 32;
    bool ok = true;
    for (int i = 0; i < 32; i++) {
      int b;
      if (fscanf(f, "%d", &b) != 1) {
        ok = false;
        break;
      }
      d[i] = (uint8_t)b;
    }
    double w;
    if (!ok || fscanf(f, "%lf", &w) != 1) break;
    v->weights[n] = w;
    n++;
  }
  v->n_nodes = n;
  fclose(f);
  return v;
}

void voc_free(VocData* v) {
  if (!v) return;
  free(v->parents);
  free(v->is_leaf);
  free(v->descs);
  free(v->weights);
  free(v);
}

}  // extern "C"
