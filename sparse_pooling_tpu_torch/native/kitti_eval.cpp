// KITTI offline AP evaluator: the port's copy of the JAX package's native
// evaluator (sparse_pooling_tpu/native/kitti_eval/kitti_eval.cpp).
//
// 2D / BEV / 3D average precision and AOS (11- or 40-point interpolation)
// over easy/moderate/hard difficulty bands per class, from KITTI-format
// label and prediction txt directories. The algorithm mirrors the numpy
// oracle (sparse_pooling_tpu_torch/runtime/metrics.py) exactly: stable
// score-descending greedy matching, ignored-GT semantics, Sutherland-Hodgman
// rotated-box overlap; tests/test_torch_eval.py holds the two together.
//
// Built by sparse_pooling_tpu_torch/native/kitti_eval.py with g++ -O2
// -std=c++17: a shared library (-DKITTI_EVAL_NO_MAIN, the ctypes ABI
// spt_evaluate_v2) and the evaluate_object_3d CLI from this same source.
// Zero dependencies beyond C++17.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <fstream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Label {
  std::string type;
  double truncation = 0, alpha = 0;
  int occlusion = 0;
  double x1 = 0, y1 = 0, x2 = 0, y2 = 0;  // 2D bbox
  double h = 0, w = 0, l = 0;             // dimensions
  double x = 0, y = 0, z = 0, ry = 0;     // location + yaw
  double score = 1.0;
};

struct Difficulty {
  double min_height;
  int max_occlusion;
  double max_truncation;
};

const Difficulty kDifficulties[3] = {
    {40.0, 0, 0.15},  // easy
    {25.0, 1, 0.30},  // moderate
    {25.0, 2, 0.50},  // hard
};

double MinOverlap(const std::string& cls) {
  return cls == "Car" ? 0.7 : 0.5;
}

bool IsSimilarClass(const std::string& cls, const std::string& other) {
  if (cls == "Car") return other == "Van";
  if (cls == "Pedestrian") return other == "Person_sitting";
  return false;
}

std::vector<Label> ParseLabelFile(const std::string& path) {
  std::vector<Label> out;
  std::ifstream f(path);
  std::string line;
  while (std::getline(f, line)) {
    std::istringstream ss(line);
    Label lb;
    double occ;
    if (!(ss >> lb.type >> lb.truncation >> occ >> lb.alpha >> lb.x1 >>
          lb.y1 >> lb.x2 >> lb.y2 >> lb.h >> lb.w >> lb.l >> lb.x >> lb.y >>
          lb.z >> lb.ry)) {
      continue;
    }
    lb.occlusion = static_cast<int>(occ);
    if (!(ss >> lb.score)) lb.score = 1.0;
    out.push_back(lb);
  }
  return out;
}

// ------------------------------------------------------------------ overlaps

double Bbox2dIou(const Label& a, const Label& b) {
  double ix = std::max(0.0, std::min(a.x2, b.x2) - std::max(a.x1, b.x1));
  double iy = std::max(0.0, std::min(a.y2, b.y2) - std::max(a.y1, b.y1));
  double inter = ix * iy;
  double area_a = std::max(a.x2 - a.x1, 0.0) * std::max(a.y2 - a.y1, 0.0);
  double area_b = std::max(b.x2 - b.x1, 0.0) * std::max(b.y2 - b.y1, 0.0);
  double uni = area_a + area_b - inter;
  return uni > 0 ? inter / std::max(uni, 1e-12) : 0.0;
}

struct Pt {
  double x, y;
};

// footprint corners (x, z) of [x, z, l, w, ry], CCW, matching the oracle
void BevCorners(double x, double z, double l, double w, double ry, Pt out[4]) {
  const double lx[4] = {l / 2, l / 2, -l / 2, -l / 2};
  const double lz[4] = {w / 2, -w / 2, -w / 2, w / 2};
  double c = std::cos(ry), s = std::sin(ry);
  for (int i = 0; i < 4; ++i) {
    out[i] = {c * lx[i] + s * lz[i] + x, -s * lx[i] + c * lz[i] + z};
  }
}

double SignedArea(const std::vector<Pt>& p) {
  double a = 0;
  for (size_t i = 0; i < p.size(); ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % p.size()];
    a += u.x * v.y - v.x * u.y;
  }
  return 0.5 * a;
}

// Sutherland-Hodgman convex clip; identical epsilons to the Python oracle.
std::vector<Pt> ClipPolygon(std::vector<Pt> subject, std::vector<Pt> clip) {
  if (SignedArea(clip) < 0) std::reverse(clip.begin(), clip.end());
  auto inside = [](const Pt& p, const Pt& a, const Pt& b) {
    return (b.x - a.x) * (p.y - a.y) - (b.y - a.y) * (p.x - a.x) >= -1e-12;
  };
  auto intersect = [](const Pt& p1, const Pt& p2, const Pt& a, const Pt& b) {
    double d1x = p2.x - p1.x, d1y = p2.y - p1.y;
    double d2x = b.x - a.x, d2y = b.y - a.y;
    double denom = d1x * d2y - d1y * d2x;
    if (std::fabs(denom) < 1e-15) return p2;
    double t = ((a.x - p1.x) * d2y - (a.y - p1.y) * d2x) / denom;
    return Pt{p1.x + t * d1x, p1.y + t * d1y};
  };
  std::vector<Pt> output = subject;
  for (size_t i = 0; i < clip.size(); ++i) {
    Pt a = clip[i], b = clip[(i + 1) % clip.size()];
    std::vector<Pt> input = output;
    output.clear();
    if (input.empty()) break;
    Pt prev = input.back();
    for (const Pt& cur : input) {
      if (inside(cur, a, b)) {
        if (!inside(prev, a, b)) output.push_back(intersect(prev, cur, a, b));
        output.push_back(cur);
      } else if (inside(prev, a, b)) {
        output.push_back(intersect(prev, cur, a, b));
      }
      prev = cur;
    }
  }
  return output;
}

double RotatedOverlapBev(double ax, double az, double al, double aw, double ar,
                         double bx, double bz, double bl, double bw,
                         double br) {
  Pt ca[4], cb[4];
  BevCorners(ax, az, al, aw, ar, ca);
  BevCorners(bx, bz, bl, bw, br, cb);
  std::vector<Pt> inter = ClipPolygon({ca, ca + 4}, {cb, cb + 4});
  if (inter.size() < 3) return 0.0;
  return std::fabs(SignedArea(inter));
}

double BevIou(const Label& a, const Label& b) {
  double inter =
      RotatedOverlapBev(a.x, a.z, a.l, a.w, a.ry, b.x, b.z, b.l, b.w, b.ry);
  double uni = a.l * a.w + b.l * b.w - inter;
  return inter / std::max(uni, 1e-12);
}

double Iou3d(const Label& a, const Label& b) {
  double inter_bev =
      RotatedOverlapBev(a.x, a.z, a.l, a.w, a.ry, b.x, b.z, b.l, b.w, b.ry);
  double y_top = std::max(a.y - a.h, b.y - b.h);
  double y_bot = std::min(a.y, b.y);
  double ih = std::max(0.0, y_bot - y_top);
  double inter = inter_bev * ih;
  double uni = a.l * a.w * a.h + b.l * b.w * b.h - inter;
  return inter / std::max(uni, 1e-12);
}

// ------------------------------------------------------------------ AP

enum Metric { kMetric2d = 0, kMetricBev = 1, kMetric3d = 2 };

// per-detection record for the PR curve: score, TP flag, and (2D metric
// only) the devkit AOS contribution (1 + cos(gt.alpha - det.alpha)) / 2.
struct DetRecord {
  double score;
  bool tp;
  double sim;
};

int GtStatus(const Label& g, const std::string& cls, const Difficulty& d) {
  if (g.type == cls) {
    double h = g.y2 - g.y1;
    if (g.occlusion > d.max_occlusion || g.truncation > d.max_truncation ||
        h < d.min_height) {
      return 0;
    }
    return 1;
  }
  if (IsSimilarClass(cls, g.type) || g.type == "DontCare") return 0;
  return -1;
}

struct Frame {
  std::vector<Label> gt;
  std::vector<Label> det;
};

// Interpolated AP over the PR curve; with use_sim, the precision numerator
// becomes the cumulative orientation similarity (the devkit's AOS curve).
double AveragePrecision(std::vector<DetRecord> score_tp, int n_gt,
                        int n_points, bool use_sim = false) {
  if (n_gt == 0 || score_tp.empty()) return 0.0;
  std::stable_sort(
      score_tp.begin(), score_tp.end(),
      [](const DetRecord& a, const DetRecord& b) { return a.score > b.score; });
  size_t n = score_tp.size();
  std::vector<double> recall(n), precision(n);
  double tp = 0, fp = 0, val = 0;
  for (size_t i = 0; i < n; ++i) {
    if (score_tp[i].tp) {
      tp += 1;
    } else {
      fp += 1;
    }
    val += use_sim ? score_tp[i].sim : (score_tp[i].tp ? 1.0 : 0.0);
    recall[i] = tp / n_gt;
    precision[i] = val / std::max(tp + fp, 1.0);
  }
  double ap = 0.0;
  int total = n_points;
  for (int k = 0; k < total; ++k) {
    double r = (n_points == 11) ? (k / 10.0)
                                : ((k + 1) / static_cast<double>(n_points));
    double best = 0.0;
    for (size_t i = 0; i < n; ++i) {
      if (recall[i] >= r) best = std::max(best, precision[i]);
    }
    ap += best / total;
  }
  return ap;
}

// Returns AP; for the 2D metric, *aos_out (if non-null) additionally gets
// the devkit Average Orientation Similarity from the same matching pass.
double EvaluateOne(const std::vector<Frame>& frames, const std::string& cls,
                   const Difficulty& diff, Metric metric, int n_points,
                   double* aos_out = nullptr) {
  double min_ov = MinOverlap(cls);
  std::vector<DetRecord> score_tp;  // non-ignored dets only
  int n_gt = 0;
  for (const Frame& fr : frames) {
    std::vector<int> status(fr.gt.size());
    for (size_t gi = 0; gi < fr.gt.size(); ++gi) {
      status[gi] = GtStatus(fr.gt[gi], cls, diff);
      if (status[gi] == 1) ++n_gt;
    }
    std::vector<int> det_idx;
    for (size_t di = 0; di < fr.det.size(); ++di) {
      if (fr.det[di].type == cls) det_idx.push_back(static_cast<int>(di));
    }
    if (det_idx.empty()) continue;
    std::stable_sort(det_idx.begin(), det_idx.end(), [&](int a, int b) {
      return fr.det[a].score > fr.det[b].score;
    });
    std::vector<bool> matched(fr.gt.size(), false);
    for (int di : det_idx) {
      const Label& d = fr.det[di];
      // devkit ignored_det semantics: a detection below the difficulty's
      // min bbox height may consume a GT but is never a TP and never an FP.
      bool d_small = (d.y2 - d.y1) < diff.min_height;
      double best_ov = 0.0;
      int best_gi = -1;
      for (size_t gi = 0; gi < fr.gt.size(); ++gi) {
        if (status[gi] == -1 || matched[gi]) continue;
        const Label& g = fr.gt[gi];
        double ov = metric == kMetric2d   ? Bbox2dIou(d, g)
                    : metric == kMetricBev ? BevIou(d, g)
                                           : Iou3d(d, g);
        if (ov > best_ov) {
          best_ov = ov;
          best_gi = static_cast<int>(gi);
        }
      }
      if (best_gi >= 0 && best_ov >= min_ov) {
        matched[best_gi] = true;
        if (status[best_gi] == 1 && !d_small) {
          double sim = 0.5 * (1.0 + std::cos(fr.gt[best_gi].alpha - d.alpha));
          score_tp.push_back({d.score, true, sim});
        }
        // matched an ignored GT (or the det is ignored): neither TP nor FP
      } else if (!d_small) {
        score_tp.push_back({d.score, false, 0.0});
      }
      // small unmatched det: ignored, not an FP
    }
  }
  if (aos_out != nullptr) {
    *aos_out = (metric == kMetric2d)
                   ? AveragePrecision(score_tp, n_gt, n_points, true)
                   : 0.0;
  }
  return AveragePrecision(std::move(score_tp), n_gt, n_points);
}

std::vector<std::string> ListTxt(const std::string& dir) {
  std::vector<std::string> out;
  DIR* d = opendir(dir.c_str());
  if (!d) return out;
  while (dirent* e = readdir(d)) {
    std::string name = e->d_name;
    if (name.size() > 4 && name.substr(name.size() - 4) == ".txt") {
      out.push_back(name);
    }
  }
  closedir(d);
  std::sort(out.begin(), out.end());
  return out;
}

std::vector<Frame> LoadFrames(const std::string& gt_dir,
                              const std::string& det_dir) {
  std::vector<Frame> frames;
  for (const std::string& fname : ListTxt(det_dir)) {
    Frame fr;
    fr.gt = ParseLabelFile(gt_dir + "/" + fname);
    fr.det = ParseLabelFile(det_dir + "/" + fname);
    frames.push_back(std::move(fr));
  }
  return frames;
}

}  // namespace

// ------------------------------------------------------------------ C ABI

extern "C" {

// out must hold n_classes * 4 metrics * 3 difficulties doubles, laid out
// [cls][metric(2d,bev,3d,aos)][difficulty(easy,mod,hard)]. classes_csv e.g.
// "Car,Pedestrian,Cyclist". Returns number of frames evaluated, < 0 on error.
// AOS (Average Orientation Similarity) uses the 2D matching with TPs
// weighted by (1 + cos(dalpha)) / 2, matching the official devkit.
int spt_evaluate_v2(const char* gt_dir, const char* det_dir,
                    const char* classes_csv, int n_points, double* out) {
  std::vector<Frame> frames = LoadFrames(gt_dir, det_dir);
  if (frames.empty()) return 0;
  std::vector<std::string> classes;
  std::stringstream ss(classes_csv);
  std::string item;
  while (std::getline(ss, item, ',')) {
    if (!item.empty()) classes.push_back(item);
  }
  size_t idx = 0;
  for (const std::string& cls : classes) {
    double aos[3] = {0, 0, 0};
    for (int m = 0; m < 3; ++m) {
      for (int di = 0; di < 3; ++di) {
        out[idx++] = EvaluateOne(frames, cls, kDifficulties[di],
                                 static_cast<Metric>(m), n_points,
                                 m == kMetric2d ? &aos[di] : nullptr);
      }
    }
    for (int di = 0; di < 3; ++di) out[idx++] = aos[di];
  }
  return static_cast<int>(frames.size());
}

}  // extern "C"

// ------------------------------------------------------------------ CLI

#ifndef KITTI_EVAL_NO_MAIN
int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: %s <gt_dir> <det_dir> [classes_csv] [n_points]\n",
                 argv[0]);
    return 2;
  }
  const char* classes = argc > 3 ? argv[3] : "Car,Pedestrian,Cyclist";
  int n_points = argc > 4 ? std::atoi(argv[4]) : 11;
  int n_cls = 1;
  for (const char* p = classes; *p; ++p) {
    if (*p == ',') ++n_cls;
  }
  std::vector<double> out(n_cls * 12, 0.0);
  int n = spt_evaluate_v2(argv[1], argv[2], classes, n_points, out.data());
  if (n <= 0) {
    std::fprintf(stderr, "no frames evaluated\n");
    return 1;
  }
  std::printf("evaluated %d frames\n", n);
  const char* metric_names[4] = {"2d", "bev", "3d", "aos"};
  const char* diff_names[3] = {"easy", "moderate", "hard"};
  std::stringstream ss(classes);
  std::string cls;
  size_t idx = 0;
  while (std::getline(ss, cls, ',')) {
    for (int m = 0; m < 4; ++m) {
      std::printf("%s AP_%s:", cls.c_str(), metric_names[m]);
      for (int d = 0; d < 3; ++d) {
        std::printf(" %s=%.4f", diff_names[d], out[idx++]);
      }
      std::printf("\n");
    }
  }
  return 0;
}
#endif
