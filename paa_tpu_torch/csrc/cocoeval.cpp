// Native COCO evaluation kernels.
//
// Plays the role pycocotools' C backend plays for the reference
// (paa_core/data/datasets/evaluation/coco/coco_eval.py drives
// pycocotools.cocoeval, whose hot loops are C): the per-image greedy
// detection<->ground-truth matching across IoU thresholds, and the
// pairwise bbox IoU with crowd ("iof") semantics. A copy of
// paa_tpu/csrc/cocoeval.cpp. The Python layer
// (paa_tpu_torch/evaluation/coco_eval.py) calls these through ctypes;
// its numpy loops are the plain versions the tests hold these against.
//
// Build: g++ -O3 -shared -fPIC -o _build/cocoeval-<hash>.so cocoeval.cpp
// (done at first use by paa_tpu_torch/ops/_build.py::load_host).

#include <cstdint>
#include <algorithm>

extern "C" {

// Pairwise IoU of xywh boxes; crowd gts use union = dt area.
// dts: n_dt*4, gts: n_gt*4, iscrowd: n_gt, out: n_dt*n_gt row-major.
void bbox_iou_xywh(const double* dts, int n_dt,
                   const double* gts, int n_gt,
                   const uint8_t* iscrowd,
                   double* out) {
    for (int j = 0; j < n_gt; ++j) {
        const double gx = gts[j * 4 + 0], gy = gts[j * 4 + 1];
        const double gw = gts[j * 4 + 2], gh = gts[j * 4 + 3];
        const double ga = gw * gh;
        for (int i = 0; i < n_dt; ++i) {
            const double dx = dts[i * 4 + 0], dy = dts[i * 4 + 1];
            const double dw = dts[i * 4 + 2], dh = dts[i * 4 + 3];
            const double da = dw * dh;
            const double x1 = std::max(dx, gx);
            const double y1 = std::max(dy, gy);
            const double x2 = std::min(dx + dw, gx + gw);
            const double y2 = std::min(dy + dh, gy + gh);
            const double iw = std::max(0.0, x2 - x1);
            const double ih = std::max(0.0, y2 - y1);
            const double inter = iw * ih;
            const double uni = iscrowd[j] ? da : da + ga - inter;
            out[i * n_gt + j] = uni > 1e-12 ? inter / uni : 0.0;
        }
    }
}

// Per-image greedy matching for all IoU thresholds (cocoeval.evaluateImg
// semantics). Inputs are GT-sorted so non-ignored gts come first.
//   ious:      n_dt * n_gt row-major
//   g_ig:      n_gt   (area-range ignore | crowd | explicit ignore)
//   g_crowd:   n_gt   (crowd gts may be matched many times)
//   dt_out_of_range: n_dt (detection area outside the range)
//   thrs:      T iou thresholds
// Outputs:
//   dtm:   T * n_dt  matched gt index or -1
//   dt_ig: T * n_dt  1 if the detection is ignored
void evaluate_img(const double* ious,
                  const uint8_t* g_ig,
                  const uint8_t* g_crowd,
                  const uint8_t* dt_out_of_range,
                  int n_dt, int n_gt,
                  const double* thrs, int T,
                  int64_t* dtm,
                  uint8_t* dt_ig) {
    // scratch: gt matched flags per threshold
    int64_t* gtm = new int64_t[n_gt];
    for (int t = 0; t < T; ++t) {
        for (int j = 0; j < n_gt; ++j) gtm[j] = -1;
        const double thr = thrs[t];
        for (int i = 0; i < n_dt; ++i) {
            double best = std::min(thr, 1.0 - 1e-10);
            int m = -1;
            for (int j = 0; j < n_gt; ++j) {
                // unavailable if already matched to a non-crowd gt
                if (gtm[j] >= 0 && !g_crowd[j]) continue;
                // stop at ignored gts once a real match exists
                if (m > -1 && !g_ig[m] && g_ig[j]) break;
                const double v = ious[i * n_gt + j];
                if (v < best) continue;
                best = v;
                m = j;
            }
            const int64_t idx = (int64_t)t * n_dt + i;
            if (m == -1) {
                dtm[idx] = -1;
                dt_ig[idx] = dt_out_of_range[i];
            } else {
                dtm[idx] = m;
                dt_ig[idx] = g_ig[m];
                gtm[m] = i;
            }
        }
    }
    delete[] gtm;
}

}  // extern "C"
