// HDBSCAN's host half: Kruskal dendrogram, condensed tree, excess-of-mass
// selection and labels over the kNN mutual-reachability graph that
// ops/hdbscan.py builds on the device.
//
// The JAX package's tree (native/npz_reader.cc: hdbscan_labels_impl) with
// one change: the edges are sorted by (weight, source row, destination), a
// total order, where the JAX package's sort orders by weight alone and
// leaves ties in an order no other implementation can reproduce. The tree
// is then a function of the edge set, whatever order the slots of a row
// hold.
//
// Built with the host's C++ compiler at first use (ops/hdbscan_tree.py);
// a plain C interface through ctypes.

#include <algorithm>
#include <cstdint>
#include <vector>

// Forest roots (the kNN graph need not be connected) are treated as
// eligible clusters so isolated components remain selectable.

namespace {

struct Dendro {
  // merge nodes n..2n-2: children + merge distance + size
  std::vector<int32_t> left, right;
  std::vector<float> dist;
  std::vector<int64_t> size;
};

int32_t dsu_find(std::vector<int32_t>& p, int32_t x) {
  while (p[x] != x) {
    p[x] = p[p[x]];
    x = p[x];
  }
  return x;
}

}  // namespace

// Weighted form: each graph node i stands for node_w[i] original points
// (voxel-dedup representatives, ops/hdbscan.py). Cluster sizes, the
// min_cluster_size gate, and stability mass all count POINTS (sum of
// weights), so the condensed tree behaves as if the duplicates were present
// — the semantics of running upstream hdbscan on the raw cloud. node_w may
// be null (all weights 1: the unweighted behaviour, byte-identical).
static int64_t hdbscan_labels_impl(
    const int32_t* edge_dst, const float* edge_w, const int32_t* node_w,
    int64_t n_points, int32_t edges_per_point, int32_t min_cluster_size,
    int32_t* out_labels) {
  const int64_t n = n_points;
  auto leaf_w = [&](int32_t v) -> int64_t {
    return node_w ? (int64_t)node_w[v] : 1;
  };
  // ---- collect + sort candidate edges --------------------------------
  struct E {
    float w;
    int32_t a, b;
  };
  std::vector<E> edges;
  edges.reserve(n * edges_per_point);
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t e = 0; e < edges_per_point; ++e) {
      int32_t j = edge_dst[i * edges_per_point + e];
      float w = edge_w[i * edges_per_point + e];
      if (j < 0 || j >= n || w >= 1e8f) continue;
      edges.push_back({w, (int32_t)i, j});
    }
  }
  // a total order, (w, a, b): mutual-reachability weights tie often, and
  // under a weight-only order the tree (and the labels) would depend on
  // the order in which the edges arrive, not on the edge set alone
  std::sort(edges.begin(), edges.end(), [](const E& x, const E& y) {
    if (x.w != y.w) return x.w < y.w;
    if (x.a != y.a) return x.a < y.a;
    return x.b < y.b;
  });

  // ---- Kruskal -> dendrogram -----------------------------------------
  std::vector<int32_t> parent(n);
  std::vector<int32_t> comp_node(n);  // dsu root -> dendrogram node id
  for (int64_t i = 0; i < n; ++i) {
    parent[i] = (int32_t)i;
    comp_node[i] = (int32_t)i;
  }
  Dendro d;
  auto node_size = [&](int32_t v) -> int64_t {
    return v < n ? leaf_w(v) : d.size[v - n];
  };
  int32_t next_node = (int32_t)n;
  for (const E& e : edges) {
    int32_t ra = dsu_find(parent, e.a);
    int32_t rb = dsu_find(parent, e.b);
    if (ra == rb) continue;
    int32_t na = comp_node[ra], nb = comp_node[rb];
    d.left.push_back(na);
    d.right.push_back(nb);
    d.dist.push_back(e.w);
    d.size.push_back(node_size(na) + node_size(nb));
    parent[ra] = rb;
    comp_node[rb] = next_node++;
  }

  // ---- roots of the dendrogram forest --------------------------------
  std::vector<char> is_child(next_node, 0);
  for (size_t i = 0; i < d.left.size(); ++i) {
    is_child[d.left[i]] = 1;
    is_child[d.right[i]] = 1;
  }

  // ---- condensed tree -------------------------------------------------
  // walk each merge node top-down carrying its condensed cluster id.
  const int32_t NOISE = -1;
  std::vector<int32_t> cond_parent;       // per condensed cluster
  std::vector<float> cond_birth;          // birth lambda
  std::vector<double> cond_stab;          // accumulated stability
  std::vector<int64_t> cond_size;
  std::vector<int32_t> point_cluster(n, NOISE);  // leaf-most membership
  std::vector<float> point_lambda(n, 0.f);

  struct Item {
    int32_t node;      // dendrogram node
    int32_t cluster;   // condensed cluster id it currently belongs to
  };
  std::vector<Item> stack;

  auto new_cluster = [&](int32_t par, float birth) {
    cond_parent.push_back(par);
    cond_birth.push_back(birth);
    cond_stab.push_back(0.0);
    cond_size.push_back(0);
    return (int32_t)(cond_parent.size() - 1);
  };
  auto assign_subtree = [&](int32_t node, int32_t cluster, float lam) {
    // all leaves under `node` fall out of `cluster` at lambda `lam`
    std::vector<int32_t> st{node};
    while (!st.empty()) {
      int32_t v = st.back();
      st.pop_back();
      if (v < n) {
        point_cluster[v] = cluster;
        point_lambda[v] = lam;
        if (cluster >= 0) {
          int64_t w = leaf_w(v);
          cond_stab[cluster] += (double)w * (lam - cond_birth[cluster]);
          cond_size[cluster] += w;
        }
      } else {
        st.push_back(d.left[v - n]);
        st.push_back(d.right[v - n]);
      }
    }
  };

  for (int32_t v = (int32_t)n; v < next_node; ++v) {
    if (!is_child[v]) {  // forest root: eligible root cluster (birth ~0)
      int32_t c = new_cluster(-1, 0.f);
      stack.push_back({v, c});
    }
  }
  // lone points that never merged stay NOISE
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    int32_t m = it.node - (int32_t)n;
    float lam = d.dist[m] > 0 ? 1.0f / d.dist[m] : 1e9f;
    int32_t l = d.left[m], r = d.right[m];
    int64_t sl = node_size(l), sr = node_size(r);
    bool bl = sl >= min_cluster_size, br = sr >= min_cluster_size;
    if (bl && br) {
      // true split: current cluster dies here; two children born
      if (it.cluster >= 0)
        cond_stab[it.cluster] +=
            (double)(sl + sr) * (lam - cond_birth[it.cluster]);
      int32_t cl = new_cluster(it.cluster, lam);
      int32_t cr = new_cluster(it.cluster, lam);
      // a LEAF can clear min_cluster_size on its own when weighted (a dense
      // voxel's representative); count its mass so EOM can select it
      if (l >= n) stack.push_back({l, cl});
      else { point_cluster[l] = cl; point_lambda[l] = 1e9f;
             cond_size[cl] += leaf_w(l); }
      if (r >= n) stack.push_back({r, cr});
      else { point_cluster[r] = cr; point_lambda[r] = 1e9f;
             cond_size[cr] += leaf_w(r); }
    } else {
      // smaller side falls out; larger side continues in the same cluster
      if (!bl) assign_subtree(l, it.cluster, lam);
      else if (l >= n) stack.push_back({l, it.cluster});
      else assign_subtree(l, it.cluster, lam);
      if (!br) assign_subtree(r, it.cluster, lam);
      else if (r >= n) stack.push_back({r, it.cluster});
      else assign_subtree(r, it.cluster, lam);
    }
  }
  // leaves assigned with lambda=1e9 (still in cluster at death) contribute
  // via the split bookkeeping above; leaf clusters accumulate per-point
  // stability through assign_subtree.

  // ---- excess-of-mass selection (bottom-up) ---------------------------
  int32_t nc = (int32_t)cond_parent.size();
  std::vector<double> subtree(nc, 0.0);
  std::vector<char> selected(nc, 0);
  std::vector<std::vector<int32_t>> children(nc);
  for (int32_t c = 0; c < nc; ++c)
    if (cond_parent[c] >= 0) children[cond_parent[c]].push_back(c);
  // iterate children-before-parents (ids grow downward from roots, so
  // reverse id order is a valid bottom-up order).
  //
  // Forest roots ARE selectable: the MST comes from a kNN graph, so each
  // spatially-isolated object is its own dendrogram root — in the complete
  // mutual-reachability graph it would merge with the rest at a huge
  // distance (lambda ~ 0), which is exactly the birth lambda these roots
  // carry. Excluding roots (upstream's allow_single_cluster=False, harmless
  // on a CONNECTED dendrogram whose root holds almost nothing) would force
  // selection down to short-lived dense-core children and shed every
  // cluster fringe as noise. Childless clusters gate on member count
  // instead: undersized isolated components must stay noise.
  for (int32_t c = nc - 1; c >= 0; --c) {
    double child_sum = 0;
    for (int32_t ch : children[c]) child_sum += subtree[ch];
    if (children[c].empty()) {
      subtree[c] = cond_stab[c];
      selected[c] = cond_size[c] >= min_cluster_size;
    } else if (cond_stab[c] > child_sum) {
      subtree[c] = cond_stab[c];
      selected[c] = 1;
      // deselect descendants
      std::vector<int32_t> st(children[c]);
      while (!st.empty()) {
        int32_t x = st.back();
        st.pop_back();
        selected[x] = 0;
        for (int32_t ch : children[x]) st.push_back(ch);
      }
    } else {
      subtree[c] = child_sum;
    }
  }

  // ---- labels ----------------------------------------------------------
  std::vector<int32_t> sel_id(nc, -1);
  int32_t n_sel = 0;
  for (int32_t c = 0; c < nc; ++c)
    if (selected[c]) sel_id[c] = n_sel++;
  for (int64_t p = 0; p < n; ++p) {
    int32_t c = point_cluster[p];
    int32_t lab = -1;
    while (c >= 0) {
      if (selected[c]) {
        lab = sel_id[c];
        break;
      }
      c = cond_parent[c];
    }
    out_labels[p] = lab;
  }
  return n_sel;
}

extern "C" int64_t icpflow_hdbscan_labels(
    const int32_t* edge_dst, const float* edge_w, int64_t n_points,
    int32_t edges_per_point, int32_t min_cluster_size,
    int32_t* out_labels) {
  return hdbscan_labels_impl(edge_dst, edge_w, nullptr, n_points,
                             edges_per_point, min_cluster_size, out_labels);
}

extern "C" int64_t icpflow_hdbscan_labels_weighted(
    const int32_t* edge_dst, const float* edge_w, const int32_t* node_w,
    int64_t n_points, int32_t edges_per_point, int32_t min_cluster_size,
    int32_t* out_labels) {
  return hdbscan_labels_impl(edge_dst, edge_w, node_w, n_points,
                             edges_per_point, min_cluster_size, out_labels);
}
