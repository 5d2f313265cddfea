// fastio: native host-side structure parsing + neighbor search.
//
// The reference framework leans on native code for its host-side heavy
// lifting (vendored smina/dssp/msms binaries, druglib/ops/*). In this
// rebuild the host bottleneck is the prep stage of large virtual screens:
// parsing thousands of PDB/SDF files and running pocket selection. This
// library implements those in C++ behind a plain C ABI consumed via
// ctypes (diffbindfr_tpu/io/native.py), with the pure-Python parsers as
// the always-available fallback.
//
// Build: g++ -O3 -march=native -shared -fPIC fastio.cpp -o libfastio.so
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ResKey {
    char chain;
    int resnum;
    char icode;
    char resname[4];
    bool operator==(const ResKey& o) const {
        return chain == o.chain && resnum == o.resnum && icode == o.icode &&
               std::strncmp(resname, o.resname, 3) == 0;
    }
};
struct ResKeyHash {
    size_t operator()(const ResKey& k) const {
        size_t h = (size_t)k.chain * 1315423911u ^ (size_t)k.resnum * 2654435761u ^
                   (size_t)k.icode * 97u;
        for (int i = 0; i < 3; ++i) h = h * 131 + (unsigned char)k.resname[i];
        return h;
    }
};

// residue-name normalization (selenomethionine, protonation variants)
const std::unordered_map<std::string, std::string>& resname_fix() {
    static const std::unordered_map<std::string, std::string> m = {
        {"MSE", "MET"}, {"HID", "HIS"}, {"HIE", "HIS"}, {"HIP", "HIS"},
        {"HSD", "HIS"}, {"HSE", "HIS"}, {"HSP", "HIS"}, {"CYX", "CYS"},
        {"CYM", "CYS"}, {"ASH", "ASP"}, {"GLH", "GLU"}, {"LYN", "LYS"},
        {"ARN", "ARG"}, {"TYM", "TYR"},
    };
    return m;
}

const char* kStdRes[] = {"ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU",
                         "GLY", "HIS", "ILE", "LEU", "LYS", "MET", "PHE",
                         "PRO", "SER", "THR", "TRP", "TYR", "VAL", "UNK"};

bool is_std_res(const char* name) {
    for (const char* r : kStdRes)
        if (std::strncmp(name, r, 3) == 0) return true;
    return false;
}

std::string strip(const char* s, int n) {
    int a = 0, b = n;
    while (a < b && std::isspace((unsigned char)s[a])) ++a;
    while (b > a && (std::isspace((unsigned char)s[b - 1]) || s[b - 1] == 0)) --b;
    return std::string(s + a, b - a);
}

}  // namespace

extern "C" {

// Parse a PDB file into per-residue atom37 arrays.
// atom37_names: 37 * 4 chars (space padded). Returns residue count, or -1
// on IO error, or -(2 + needed) if max_res is too small.
int fp_parse_pdb(const char* path, const char* atom37_names, int max_res,
                 float* pos,        // [max_res, 37, 3]
                 float* mask,       // [max_res, 37]
                 float* bfac,       // [max_res, 37]
                 int* resnum,       // [max_res]
                 char* chains,      // [max_res]
                 char* icodes,      // [max_res]
                 char* resnames)    // [max_res * 3]
{
    FILE* fh = std::fopen(path, "rb");
    if (!fh) return -1;

    std::unordered_map<std::string, int> name_to_37;
    for (int i = 0; i < 37; ++i)
        name_to_37[strip(atom37_names + 4 * i, 4)] = i;

    std::unordered_map<ResKey, int, ResKeyHash> index;
    int n_res = 0;
    int current_model = 1;
    bool done = false;

    char line[256];
    while (!done && std::fgets(line, sizeof line, fh)) {
        size_t len = std::strlen(line);
        while (len && (line[len - 1] == '\n' || line[len - 1] == '\r'))
            line[--len] = 0;
        if (len < 6) continue;
        if (std::strncmp(line, "MODEL ", 6) == 0) {
            // short MODEL lines leave line+10 beyond the terminator (stale
            // bytes from the previous fgets) -> treat as model 1
            current_model = len >= 11 ? std::atoi(line + 10) : 1;
            continue;
        }
        if (std::strncmp(line, "ENDMDL", 6) == 0) break;  // first model only
        bool het = std::strncmp(line, "HETATM", 6) == 0;
        if (!het && std::strncmp(line, "ATOM  ", 6) != 0) continue;
        if (current_model != 1) continue;
        if (len < 54) continue;

        char resname[4] = {line[17], line[18], line[19], 0};
        std::string rn = strip(resname, 3);
        auto fix = resname_fix().find(rn);
        if (het) {
            if (fix == resname_fix().end()) continue;  // ligand/water/ion
            rn = fix->second;
        } else if (fix != resname_fix().end()) {
            rn = fix->second;
        }
        if (rn == "HOH") continue;

        std::string atom = strip(line + 12, 4);
        char elem0 = len >= 78 ? line[76] : ' ';
        char elem1 = len >= 78 ? line[77] : ' ';
        // skip hydrogens / deuterium
        if ((elem0 == ' ' && (elem1 == 'H' || elem1 == 'D')) ||
            (elem0 == 'H' && elem1 == ' ') || (elem0 == 'D' && elem1 == ' '))
            continue;
        if (len < 78 && !atom.empty() &&
            (atom[0] == 'H' ||
             ((atom[0] == '1' || atom[0] == '2' || atom[0] == '3') &&
              atom.size() > 1 && atom[1] == 'H')))
            continue;

        char altloc = line[16];
        if (altloc != ' ' && altloc != 'A' && altloc != '1') continue;

        int a37;
        auto it = name_to_37.find(atom);
        if (it == name_to_37.end()) {
            if (atom == "SE" && rn == "MET")
                a37 = name_to_37.at("SD");
            else
                continue;
        } else {
            a37 = it->second;
        }

        ResKey key;
        key.chain = line[21];
        key.resnum = std::atoi(std::string(line + 22, 4).c_str());
        key.icode = line[26];
        std::strncpy(key.resname, rn.c_str(), 3);
        key.resname[3] = 0;

        auto ins = index.find(key);
        int ri;
        if (ins == index.end()) {
            if (n_res >= max_res) {
                std::fclose(fh);
                return -(2 + n_res + 1);
            }
            ri = n_res++;
            index.emplace(key, ri);
            resnum[ri] = key.resnum;
            chains[ri] = key.chain;
            icodes[ri] = key.icode;
            std::memcpy(resnames + 3 * ri, key.resname, 3);
        } else {
            ri = ins->second;
        }
        if (mask[ri * 37 + a37] > 0) continue;  // duplicate record

        float x = std::strtof(std::string(line + 30, 8).c_str(), nullptr);
        float y = std::strtof(std::string(line + 38, 8).c_str(), nullptr);
        float z = std::strtof(std::string(line + 46, 8).c_str(), nullptr);
        float b = len >= 66 ? std::strtof(std::string(line + 60, 6).c_str(), nullptr)
                            : 0.0f;
        float* p = pos + (ri * 37 + a37) * 3;
        p[0] = x;
        p[1] = y;
        p[2] = z;
        mask[ri * 37 + a37] = 1.0f;
        bfac[ri * 37 + a37] = b;
    }
    std::fclose(fh);
    return n_res;
}

// Parse the first molecule of an SDF (V2000). Returns n_atoms or -1/-2.
int fp_parse_sdf_v2000(const char* path, int max_atoms, int max_bonds,
                       float* coords,     // [max_atoms, 3]
                       char* elements,    // [max_atoms * 2]
                       int* charges,      // [max_atoms]
                       int* bonds,        // [max_bonds, 2]
                       int* orders,       // [max_bonds]
                       int* n_bonds_out) {
    FILE* fh = std::fopen(path, "rb");
    if (!fh) return -1;
    char line[512];
    // 3 header lines
    for (int i = 0; i < 3; ++i)
        if (!std::fgets(line, sizeof line, fh)) { std::fclose(fh); return -2; }
    if (!std::fgets(line, sizeof line, fh)) { std::fclose(fh); return -2; }
    int na = std::atoi(std::string(line, 3).c_str());
    int nb = std::atoi(std::string(line + 3, 3).c_str());
    if (na > max_atoms || nb > max_bonds) { std::fclose(fh); return -3; }
    for (int i = 0; i < na; ++i) {
        if (!std::fgets(line, sizeof line, fh)) { std::fclose(fh); return -2; }
        coords[i * 3 + 0] = std::strtof(std::string(line, 10).c_str(), nullptr);
        coords[i * 3 + 1] = std::strtof(std::string(line + 10, 10).c_str(), nullptr);
        coords[i * 3 + 2] = std::strtof(std::string(line + 20, 10).c_str(), nullptr);
        std::string el = strip(line + 31, 3);
        elements[i * 2] = el.size() > 0 ? el[0] : ' ';
        elements[i * 2 + 1] = el.size() > 1 ? el[1] : ' ';
        charges[i] = 0;
        if (std::strlen(line) >= 39) {
            int cc = std::atoi(std::string(line + 36, 3).c_str());
            if (cc >= 1 && cc <= 7 && cc != 4) charges[i] = 4 - cc;
        }
    }
    for (int i = 0; i < nb; ++i) {
        if (!std::fgets(line, sizeof line, fh)) { std::fclose(fh); return -2; }
        bonds[i * 2 + 0] = std::atoi(std::string(line, 3).c_str()) - 1;
        bonds[i * 2 + 1] = std::atoi(std::string(line + 3, 3).c_str()) - 1;
        orders[i] = std::atoi(std::string(line + 6, 3).c_str());
    }
    // M  CHG overrides
    while (std::fgets(line, sizeof line, fh)) {
        if (std::strncmp(line, "M  END", 6) == 0) break;
        if (std::strncmp(line, "M  CHG", 6) == 0) {
            int cnt = std::atoi(std::string(line + 6, 3).c_str());
            for (int k = 0; k < cnt; ++k) {
                int at = std::atoi(std::string(line + 9 + 8 * k, 4).c_str()) - 1;
                int ch = std::atoi(std::string(line + 13 + 8 * k, 4).c_str());
                if (at >= 0 && at < na) charges[at] = ch;
            }
        }
    }
    std::fclose(fh);
    *n_bonds_out = nb;
    return na;
}

// Cell-list "any atom within cutoff of reference points" per residue.
// prot: flattened existing atoms with residue ids. Marks hit[res] = 1.
void fp_pocket_hits(const float* atom_xyz, const int* atom_res, int n_atoms,
                    const float* ref_xyz, int n_ref, float cutoff,
                    unsigned char* hit /* [n_res], zero-initialized */) {
    if (n_atoms == 0 || n_ref == 0) return;
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = 0; i < n_ref; ++i)
        for (int d = 0; d < 3; ++d) {
            lo[d] = std::fmin(lo[d], ref_xyz[i * 3 + d]);
            hi[d] = std::fmax(hi[d], ref_xyz[i * 3 + d]);
        }
    const float c2 = cutoff * cutoff;
    const float cell = cutoff;
    int dims[3];
    for (int d = 0; d < 3; ++d) {
        lo[d] -= cutoff;
        hi[d] += cutoff;
        dims[d] = std::max(1, (int)std::ceil((hi[d] - lo[d]) / cell));
    }
    auto cell_of = [&](const float* p, int* c) {
        for (int d = 0; d < 3; ++d) {
            float v = (p[d] - lo[d]) / cell;
            c[d] = (int)std::floor(v);
            if (c[d] < 0 || c[d] >= dims[d]) return false;
        }
        return true;
    };
    std::unordered_map<int64_t, std::vector<int>> grid;
    for (int i = 0; i < n_ref; ++i) {
        int c[3];
        if (!cell_of(ref_xyz + i * 3, c)) continue;
        int64_t key = ((int64_t)c[0] * dims[1] + c[1]) * dims[2] + c[2];
        grid[key].push_back(i);
    }
    for (int i = 0; i < n_atoms; ++i) {
        int ri = atom_res[i];
        if (hit[ri]) continue;
        int c[3];
        if (!cell_of(atom_xyz + i * 3, c)) continue;
        bool found = false;
        for (int dx = -1; dx <= 1 && !found; ++dx)
            for (int dy = -1; dy <= 1 && !found; ++dy)
                for (int dz = -1; dz <= 1 && !found; ++dz) {
                    int cx = c[0] + dx, cy = c[1] + dy, cz = c[2] + dz;
                    if (cx < 0 || cy < 0 || cz < 0 || cx >= dims[0] ||
                        cy >= dims[1] || cz >= dims[2])
                        continue;
                    auto it = grid.find(
                        ((int64_t)cx * dims[1] + cy) * dims[2] + cz);
                    if (it == grid.end()) continue;
                    for (int j : it->second) {
                        float dx0 = atom_xyz[i * 3] - ref_xyz[j * 3];
                        float dy0 = atom_xyz[i * 3 + 1] - ref_xyz[j * 3 + 1];
                        float dz0 = atom_xyz[i * 3 + 2] - ref_xyz[j * 3 + 2];
                        if (dx0 * dx0 + dy0 * dy0 + dz0 * dz0 < c2) {
                            found = true;
                            break;
                        }
                    }
                }
        if (found) hit[ri] = 1;
    }
}

}  // extern "C"
